"""Exact quartic line search via closed-form cubic roots.

The port of ``ltr_lowrank_sdp_tpu/ops/cubic.py``.  The ALM subproblem
objective along a direction D is the exact quartic

    phi(tau) = a tau^4 + b tau^3 + c tau^2 + d tau

with coefficients from q0 = b_rhs - A(RR^T), q1 = 2 A(sym(RD^T)),
q2 = A(DD^T), p1 = 2<C, sym(RD^T)>, p2 = <C, DD^T> (reference
``ALMCalq12p12``, ``lorads_alm.c:714-734``), minimized exactly on
[0, tau_max] by solving phi'(tau) = 0 with Cardano's formula
(``LORADScubic_equation`` / ``ALMLineSearch``, ``lorads_alm.c:191-333``).

The four coefficients are inner products on the device
(:func:`quartic_coeffs`); the root finding and the choice of tau are a few
float64 scalar operations on the host (:func:`quartic_argmin`), because the
ALM loop reads tau there anyway to decide whether the step is taken.
``root_num == 0`` (the degenerate discriminant case) maps to a
numerical-error exit in the caller, as in the reference.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def _nthroot3(x: float) -> float:
    """Real cube root (sign-preserving)."""
    return math.copysign(abs(x) ** (1.0 / 3.0), x) if x != 0.0 else 0.0


def cubic_roots(a: float, b: float, c: float, d: float
                ) -> Tuple[List[float], int]:
    """Real roots of a x^3 + b x^2 + c x + d = 0, Cardano/Shengjin style.

    Returns (roots[3], root_num) with the reference's case analysis
    (including its clamping of the single-root cases at 0); invalid slots
    are 0.  Coefficients are pre-scaled to unit magnitude (roots are
    invariant), as the JAX package does.
    """
    scale = max(max(abs(a), abs(b)), max(abs(c), abs(d)))
    if not scale > 0.0:
        scale = 1.0
    a, b, c, d = a / scale, b / scale, c / scale, d / scale

    A = b * b - 3.0 * a * c
    B = b * c - 9.0 * a * d
    C = c * c - 3.0 * b * d
    delta = B * B - 4.0 * A * C
    safe_a = 1.0 if a == 0.0 else a

    if A == 0.0 and B == 0.0:                       # triple / linear root
        return [max(0.0, -c / (1.0 if b == 0.0 else b)), 0.0, 0.0], 1
    if delta > 0.0:                                 # one real root
        sq_delta = math.sqrt(delta)
        Y1 = A * b + 1.5 * a * (-B + sq_delta)
        Y2 = A * b + 1.5 * a * (-B - sq_delta)
        root = max(0.0, (-b - _nthroot3(Y1) - _nthroot3(Y2)) / (3.0 * safe_a))
        return [root, 0.0, 0.0], 1
    if delta == 0.0 and A != 0.0 and B != 0.0:      # double root
        K = B / A
        return [-b / safe_a + K, -K / 2.0, 0.0], 2
    if delta < 0.0:                                 # three real roots
        sqA = math.sqrt(max(A, 0.0))
        safe_sqA3 = A * sqA if A > 0.0 else 1.0
        T = min(max((A * b - 1.5 * a * B) / safe_sqA3, -1.0), 1.0)
        theta = math.acos(T)
        csth = math.cos(theta / 3.0)
        sn3th = math.sqrt(3.0) * math.sin(theta / 3.0)
        r1 = (-b - 2.0 * sqA * csth) / (3.0 * safe_a)
        r2 = (-b + sqA * (csth + sn3th)) / (3.0 * safe_a)
        r3 = (-b + sqA * (csth - sn3th)) / (3.0 * safe_a)
        return [r1, r2, r3], 3
    return [0.0, 0.0, 0.0], 0                       # NaN / degenerate


def quartic_coeffs(rho: float, lam, p1, p2, q0, q1, q2) -> torch.Tensor:
    """(a, b, c, d) of phi as a (4,) device tensor.  ``q0 = b - A(RR^T)``
    without the lambda/rho shift (applied here)."""
    q0s = q0 + lam / rho
    a = rho * torch.dot(q2, q2) / 2.0
    b = rho * torch.dot(q1, q2)
    c = p2 - rho * torch.dot(q0s, q2) + rho * torch.dot(q1, q1) / 2.0
    d = p1 - rho * torch.dot(q0s, q1)
    return torch.stack([a, b, c, d])


def quartic_argmin(a: float, b: float, c: float, d: float,
                   tau_max: float = 1.0) -> Tuple[float, int]:
    """Exact minimizer of phi on [0, tau_max] -> (tau, root_num)."""
    roots, root_num = cubic_roots(4.0 * a, 3.0 * b, 2.0 * c, d)

    def phi(x):
        return ((a * x + b) * x + c) * x * x + d * x

    cand_tau = [0.0, tau_max] + roots
    cand_f = [0.0, phi(tau_max)]
    for i, x in enumerate(roots):
        valid = x > 1e-20 and x <= tau_max and i < root_num
        cand_f.append(phi(x) if valid else 1e30)
    best = 0
    for i in range(1, len(cand_f)):
        # first minimum wins (jnp.argmin); a NaN candidate wins like in XLA
        if cand_f[i] < cand_f[best] or (math.isnan(cand_f[i])
                                        and not math.isnan(cand_f[best])):
            best = i
    return cand_tau[best], root_num


def quartic_linesearch(rho: float, lam, p1, p2, q0, q1, q2,
                       tau_max: float = 1.0) -> Tuple[float, int]:
    """Coefficients on the device, one host read, exact argmin."""
    a, b, c, d = quartic_coeffs(rho, lam, p1, p2, q0, q1, q2).tolist()
    return quartic_argmin(a, b, c, d, tau_max)
