"""A (batch, constr) grid of ``torch.distributed`` ranks.

The port of ``ltr_lowrank_sdp_tpu/parallel/mesh.py``.  Two parallel axes
cover the problem domain:

* ``batch``  — independent SDP instances: pure data parallelism, no
  communication between instances (:mod:`.batch`);
* ``constr`` — the constraint axis of one large instance: each rank owns a
  share of the cone's constraint entries, factors are replicated, and each
  hot operator ends in one all-reduce over the axis (:mod:`.meshops`).

Where the JAX package lays devices out under one controller, here every rank
is its own process: :func:`make_mesh` lays the ranks of the default process
group out row-major, as ``np.array(devs).reshape(batch, n // batch)`` does,
and builds one ``torch.distributed`` group per row (the ``constr`` axis) and
per column (the ``batch`` axis).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


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

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.groups[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords[self.axis_names.index(axis)]


def make_mesh(batch: Optional[int] = None, axis_names=("batch", "constr"),
              device=None) -> Mesh:
    """Lay the default process group's ranks out as a (batch, constr) grid.

    Every rank calls this with the same arguments (the groups are created
    collectively).  ``batch`` fixes the batch-axis size (it must divide the
    world size); by default every rank is on the constraint axis.  The
    device is ``cuda:<local rank % device count>``, made the current one,
    unless ``device`` names another (``"cpu"`` for the plain versions); it
    never drops to the CPU on its own.  A world of one process is a 1 x 1
    mesh."""
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
        dev = torch.device("cuda", local % torch.cuda.device_count())
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
