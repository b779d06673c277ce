"""ltr_lowrank_sdp_torch — the PyTorch/CUDA port of ``ltr_lowrank_sdp_tpu``.

The LoRADS-class Burer-Monteiro solver (ALM -> ADMM -> Lanczos dual
certificate) for every cone the JAX package reads (diag, sparse and dense
constraints, several blocks, an LP cone), in float64 or float32, with its
float64 polish; the HALLaR solver; the rank-schedule predictor (GATv2 + LSTM)
with its serve, benchmark, training and tuning entry points; the label
pipeline (the native SDPA parser, the instance generator, the harvester and
the schedule writer of ``scripts/``); and the parallel modes
(constraint-sharded and row-sharded solves, batched ALM steps).  The conic
operators, the predictor's segment softmax and pooling and their backward
passes run through thirteen hand-written CUDA kernels (``csrc/``, bound in
:mod:`.ops.kernels`); the ALM inner pass and the ADMM chunks with their CG
run as device-resident loops, replayed as CUDA graphs with conditional nodes
(:mod:`.solver.devloop`).

Entry points run on ``cuda:0`` unless the caller asks for the CPU; with no
GPU present they raise instead of falling back silently.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["SDPProblem", "SolverParams", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``cuda:0``.  A CUDA device without a visible GPU raises
    :class:`RuntimeError`; the CPU is used only when asked for by name.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(cli: --device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


# the JAX package's two exports (after resolve_device, which the solver's
# modules import from here)
from .config import SolverParams  # noqa: E402,F401
from .problem import SDPProblem  # noqa: E402,F401
