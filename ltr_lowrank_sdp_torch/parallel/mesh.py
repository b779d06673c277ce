"""A (batch, constr) grid of ``torch.distributed`` ranks.

The port of ``ltr_lowrank_sdp_tpu/parallel/mesh.py``.  Two parallel axes
cover the problem domain:

* ``batch``  — independent SDP instances: pure data parallelism, no
  communication between instances (:mod:`.batch`);
* ``constr`` — the constraint axis of one large instance: each rank owns a
  share of the cone's constraint entries, factors are replicated, and each
  hot operator ends in one all-reduce over the axis (:mod:`.meshops`);
* ``row`` (``make_mesh(axis_names=("batch", "row"))``, in place of
  ``constr``) — the factor rows of one huge instance: each rank owns a
  share of every cone's rows, and every sum over rows ends in one
  collective over the axis (:mod:`.rowshard`).

Where the JAX package lays devices out under one controller, here every rank
is its own process: :func:`make_mesh` lays the ranks of the default process
group out row-major, as ``np.array(devs).reshape(batch, n // batch)`` does,
and builds one ``torch.distributed`` group per row (the ``constr`` axis) and
per column (the ``batch`` axis).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .launch import check_nccl_world


@dataclasses.dataclass
class Mesh:
    """One rank's view of the grid: the axis sizes, its own coordinates, its
    groups along each axis and the device it computes on."""

    shape: Dict[str, int]
    axis_names: Tuple[str, str]
    rank: int
    coords: Tuple[int, int]
    device: torch.device
    groups: Dict[str, object]
    agree_calls: int = 0        # the all-reduces (and host reads) of agree

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.groups[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def agree(self, axis: str, *flags: bool) -> Tuple[bool, ...]:
        """Each flag as set on any rank of this rank's line along ``axis``,
        the same on every rank of it: one ``all_reduce(MAX)`` of the flags.
        A sharded solve passes its stop decisions (time up, interrupted)
        through here, so that its ranks take one branch in one iteration, as
        the JAX package's single SPMD program does."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.groups[axis])
        self.agree_calls += 1
        return tuple(bool(v) for v in t.tolist())


def make_mesh(batch: Optional[int] = None, axis_names=("batch", "constr"),
              device=None) -> Mesh:
    """Lay the default process group's ranks out as a (batch, constr) grid.

    Every rank calls this with the same arguments (the groups are created
    collectively).  ``batch`` fixes the batch-axis size (it must divide the
    world size); by default every rank is on the constraint axis.  The
    device is ``cuda:<local rank>`` over NCCL (a world larger than the card
    count is refused) and ``cuda:<local rank % device count>`` over gloo
    (ranks may share a card), made the current one, unless ``device`` names
    another (``"cpu"`` for the plain versions); it never drops to the CPU on
    its own.  A world of one process is a 1 x 1 mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if batch is None:
        batch = 1
    if n % batch != 0:
        raise ValueError(f"batch axis {batch} does not divide {n} devices")
    c = n // batch
    rank = dist.get_rank()
    i, j = divmod(rank, c)
    groups = {}
    # every rank creates every group, in the same order
    for row in range(batch):
        g = dist.new_group([row * c + k for k in range(c)])
        if row == i:
            groups[axis_names[1]] = g
    for col in range(c):
        g = dist.new_group([k * c + col for k in range(batch)])
        if col == j:
            groups[axis_names[0]] = g
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the mesh on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if dist.get_backend() == "nccl":
            check_nccl_world(n)
        else:
            local %= torch.cuda.device_count()
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # one all-reduce on each of this rank's groups sets up its communicator
    # now (NCCL's takes about a second at its first use), not in the solve
    for axis in axis_names:
        dist.all_reduce(torch.zeros(1, device=dev), group=groups[axis])
    return Mesh(shape={axis_names[0]: batch, axis_names[1]: c},
                axis_names=tuple(axis_names), rank=rank, coords=(i, j),
                device=dev, groups=groups)


def collective_ms(group, nbytes: int, device: torch.device,
                  iters: int = 50) -> float:
    """Mean milliseconds of one ``all_reduce`` of ``nbytes`` (float64) over
    ``group``, every rank of which calls this together: after a warm-up and
    a barrier, CUDA events around ``iters`` calls over NCCL, the host clock
    to a synchronize over gloo (which reduces through the host)."""
    buf = torch.zeros(max(1, int(nbytes) // 8), dtype=torch.float64,
                      device=device)
    for _ in range(3):
        dist.all_reduce(buf, group=group)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    dist.barrier(group=group)
    if not (cuda and dist.get_backend(group) == "nccl"):
        t = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(buf, group=group)
        if cuda:
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        dist.all_reduce(buf, group=group)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
