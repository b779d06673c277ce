"""ltr_lowrank_sdp_torch — the PyTorch/CUDA port of ``ltr_lowrank_sdp_tpu``.

The LoRADS-class Burer-Monteiro solver (ALM -> ADMM -> Lanczos dual
certificate) on an NVIDIA GPU.  The hot conic operators of the MaxCut family
run through hand-written CUDA kernels (``csrc/``, bound in
:mod:`.ops.kernels`); everything around them is plain PyTorch in float64.

Entry points run on ``cuda:0`` unless the caller asks for the CPU; with no
GPU present they raise instead of falling back silently.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


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
