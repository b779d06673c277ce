"""Start a function on every rank of a fresh ``torch.distributed`` world.

Nothing tells a program of a cluster here, so :func:`spawn` starts the ranks
itself with :mod:`torch.multiprocessing` and initializes their process group
from a ``file://`` store in a temporary directory (no port to collide with
under parallel test workers), runs ``fn(*args)`` on each, and returns what
each rank returned.  A rank that raises makes :func:`spawn` raise after the
other ranks have been stopped.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600.0       # a collective that waits longer than this fails


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               store: str, out_dir: str, args: Sequence,
               timeout: float) -> None:
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    card = None
    if backend == "nccl":
        # one rank per card (spawn checked that there are enough): bind it,
        # so NCCL need not guess
        card = torch.device("cuda", rank)
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout),
                            device_id=card)
    try:
        result = fn(*args)
        if card is None:
            dist.barrier()
        else:
            dist.barrier(device_ids=[card.index])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def check_nccl_world(world_size: int) -> None:
    """Refuse an NCCL world of more ranks than this host has cards: NCCL
    takes one card a rank, and two ranks bound to one card fail later with
    an opaque duplicate-GPU error."""
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(f"{world_size} NCCL ranks need {world_size} cards, "
                         f"this host has {cards}: NCCL runs one rank a card "
                         f"(gloo can share one)")


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          backend: str = "gloo", timeout: float = TIMEOUT_S) -> List:
    """Run ``fn(*args)`` on ``world_size`` new processes joined in one
    process group (``backend``: ``"gloo"``, which also all-reduces CUDA
    tensors through the host, or ``"nccl"``) and return the list of their
    results, by rank.  ``fn`` and its results must pickle; each rank runs
    one torch thread (the ranks share the host's cores).  A collective
    that waits ``timeout`` seconds fails its rank.  NCCL rank r runs on
    ``cuda:r``; an NCCL world larger than the card count is refused
    (:func:`check_nccl_world`) before any rank starts."""
    if backend == "nccl":
        check_nccl_world(world_size)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, args=(fn, world_size, backend,
                              os.path.join(tmp, "store"), tmp, tuple(args),
                              timeout),
            nprocs=world_size, join=True, start_method="spawn")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
