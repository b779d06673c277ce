"""Objective and duality-gap reductions in native float64.

The JAX package carries compensated (double-single) sums because a TPU has
no native float64 (``ltr_lowrank_sdp_tpu/ops/compsum.py``).  The H100 has
native FP64, so on the port's float64 compute ``csum`` and ``cvdot`` are
plain float64 reductions; both return 0-dim tensors left on the device.
"""

from __future__ import annotations

import torch


def csum(x: torch.Tensor) -> torch.Tensor:
    """Sum of all entries of a float64 tensor."""
    _check_f64(x)
    return torch.sum(x)


def cvdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product <x, y> over all entries of two float64 tensors."""
    _check_f64(x)
    return torch.dot(x.reshape(-1), y.reshape(-1))


def _check_f64(x: torch.Tensor) -> None:
    if x.dtype != torch.float64:
        raise NotImplementedError(
            "float32 compute is a later slice of the port; got "
            f"{x.dtype}")
