"""Objective and duality-gap reductions with float64 accumulation.

The port of ``ltr_lowrank_sdp_tpu/ops/compsum.py``.  ``csum`` / ``cvdot``
reduce a float64 tensor as it is and a float32 tensor in float64 (an exact
cast, then a float64 sum), returning the input's dtype, as the reference's
do (``compsum.py:78-100``: its docstring measures the float64 reduction as
both faster and more exact than the error-free-transformation tree).  Both
return 0-dim tensors left on the device.

``two_sum``, ``_split`` and ``two_prod`` are the error-free transformations
the reference keeps beside them (its solver reaches none of them); they are
ported as plain tensor functions so that the two packages stay comparable.
"""

from __future__ import annotations

import torch

_SPLIT_F32 = 4097.0       # 2^12 + 1 (float32: 24-bit mantissa)
_SPLIT_F64 = 134217729.0  # 2^27 + 1 (float64: 53-bit mantissa)


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free addition: returns (s, err) with s + err == a + b."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split(a: torch.Tensor):
    c = (_SPLIT_F64 if a.dtype == torch.float64 else _SPLIT_F32) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """Error-free product: returns (p, err) with p + err == a * b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def csum(x: torch.Tensor) -> torch.Tensor:
    """Sum of all entries, accumulated in float64, in the input's dtype."""
    if x.dtype == torch.float64:
        return torch.sum(x)
    return torch.sum(x.reshape(-1).double()).to(x.dtype)


def cvdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product <x, y> over all entries, accumulated in float64, in the
    input's dtype (see :func:`csum`)."""
    if x.dtype == torch.float64:
        return torch.dot(x.reshape(-1), y.reshape(-1))
    return torch.dot(x.reshape(-1).double(),
                     y.reshape(-1).double()).to(x.dtype)


def cnorm2(x: torch.Tensor) -> torch.Tensor:
    """L2 norm through :func:`cvdot`."""
    return torch.sqrt(cvdot(x, x))
