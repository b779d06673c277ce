"""Scalar arithmetic of the solver's control state on the device.

The eager loops keep rho, tau, the tolerances and the DIMACS errors as host
floats; the device-resident loops (``solver/devloop.py``) keep them as
0-dim float64 tensors.  These helpers give a device scalar the rounding its
host float had:

* :func:`smul` and :func:`sdiv` for a tensor scaled by a scalar, as
  ``s * x`` and ``x / s`` with a host float ``s`` round.  PyTorch casts a
  host scalar to the tensor's type first, so a float32 tensor is scaled by
  ``s`` rounded to float32; on CUDA it also divides by a host scalar as a
  multiplication by its reciprocal, taken on the host in float64 from the
  float64 ``s`` and then rounded to the tensor's type (``x * (1 / s)``,
  one rounding more than ``x / s``; for a float32 tensor some ``s`` give
  other bits than ``x / float32(s)`` or ``x * (1 / float32(s))``), while
  it divides by a tensor exactly.  On the CPU both divide exactly.
* :func:`hdiv` for a quotient that the eager loop took on the host in
  float64 (correctly rounded): a division by a tensor, on every device;
* :func:`hsqrt` for a square root it took there: CUDA's is correctly
  rounded, PyTorch's CPU one is not always (it parts from the host's in the
  last bit of about 1 in 200 values), so on the CPU the host takes it.
"""

from __future__ import annotations

import math
from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


def smul(s: Scalar, x: torch.Tensor) -> torch.Tensor:
    """``s * x`` in ``x``'s type, rounded as with a host float ``s``."""
    if isinstance(s, torch.Tensor):
        return s.to(x.dtype) * x
    return s * x


def sdiv(x: torch.Tensor, s: Scalar) -> torch.Tensor:
    """``x / s`` in ``x``'s type, rounded as with a host float ``s``."""
    if not isinstance(s, torch.Tensor):
        return x / s
    if x.is_cuda:
        return x * torch.reciprocal(s.double()).to(x.dtype)
    return x / s.to(x.dtype)


def hdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a float64 scalar ``x`` and a constant ``c``, correctly
    rounded like the host's float64 division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def hsqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root of a float64 scalar, correctly rounded like the
    host's ``math.sqrt`` (on the CPU a host read, free there)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.tensor(math.sqrt(float(x)), dtype=x.dtype)
