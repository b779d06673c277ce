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

The batched ALM steps (``parallel/batch.py``) take no host read per step,
as the JAX ``fori_loop`` takes none: :func:`quartic_argmin_t` is the JAX
package's branch-free line search on tensors of any shape, every case
computed and selected with ``torch.where`` on the device.
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


# --------------------------------------------------------------------------- #
# the branch-free line search on the device, for a batch of quartics
# --------------------------------------------------------------------------- #


def _cbrt_t(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots_t(a, b, c, d):
    """:func:`cubic_roots` on tensors of any shape, every case computed and
    the right one selected with ``torch.where`` (the JAX package's
    branch-free ``ops/cubic.py`` ``cubic_roots``).  Returns (roots (..., 3),
    root_num (...,))."""
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()),
                          torch.maximum(c.abs(), d.abs()))
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    a, b, c, d = a / scale, b / scale, c / scale, d / scale
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)

    A = b * b - 3.0 * a * c
    B = b * c - 9.0 * a * d
    C = c * c - 3.0 * b * d
    delta = B * B - 4.0 * A * C
    safe_a = torch.where(a == 0.0, one, a)
    safe_b = torch.where(b == 0.0, one, b)
    safe_A = torch.where(A == 0.0, one, A)

    root_lin = torch.clamp(-c / safe_b, min=0.0)
    sq_delta = torch.sqrt(torch.clamp(delta, min=0.0))
    Y1 = A * b + 1.5 * a * (-B + sq_delta)
    Y2 = A * b + 1.5 * a * (-B - sq_delta)
    root_pos = torch.clamp((-b - _cbrt_t(Y1) - _cbrt_t(Y2)) / (3.0 * safe_a),
                           min=0.0)
    K = B / safe_A
    root_dz1 = -b / safe_a + K
    root_dz2 = -K / 2.0
    sqA = torch.sqrt(torch.clamp(A, min=0.0))
    safe_sqA3 = torch.where(A > 0.0, A * sqA, one)
    T = torch.clamp((A * b - 1.5 * a * B) / safe_sqA3, -1.0, 1.0)
    theta = torch.arccos(T)
    csth = torch.cos(theta / 3.0)
    sn3th = math.sqrt(3.0) * torch.sin(theta / 3.0)
    r1 = (-b - 2.0 * sqA * csth) / (3.0 * safe_a)
    r2 = (-b + sqA * (csth + sn3th)) / (3.0 * safe_a)
    r3 = (-b + sqA * (csth - sn3th)) / (3.0 * safe_a)

    case_lin = (A == 0.0) & (B == 0.0)
    case_pos = ~case_lin & (delta > 0.0)
    case_dz = ~case_lin & (delta == 0.0) & (A != 0.0) & (B != 0.0)
    case_tri = ~case_lin & (delta < 0.0)
    root0 = torch.where(case_lin, root_lin, torch.where(
        case_pos, root_pos, torch.where(case_dz, root_dz1,
                                        torch.where(case_tri, r1, zero))))
    root1 = torch.where(case_dz, root_dz2, torch.where(case_tri, r2, zero))
    root2 = torch.where(case_tri, r3, zero)
    root_num = torch.where(
        case_lin | case_pos, 1,
        torch.where(case_dz, 2, torch.where(case_tri, 3, 0)))
    return torch.stack([root0, root1, root2], dim=-1), root_num


def quartic_argmin_t(a, b, c, d):
    """:func:`quartic_argmin` on [0, 1] for tensors of any shape, on their
    device with no host read: (tau, root_num).  Candidates 0, 1 and the
    valid roots; the first minimum wins, as ``jnp.argmin`` picks it."""
    roots, root_num = cubic_roots_t(4.0 * a, 3.0 * b, 2.0 * c, d)
    a, b, c, d = (x[..., None] for x in (a, b, c, d))

    def phi(x):
        return ((a * x + b) * x + c) * x * x + d * x

    tmax = torch.ones_like(a)
    valid = ((roots > 1e-20) & (roots <= 1.0)
             & (torch.arange(3, device=roots.device) < root_num[..., None]))
    froots = torch.where(valid, phi(roots), torch.full_like(roots, 1e30))
    cand_f = torch.cat([torch.zeros_like(a), phi(tmax), froots], dim=-1)
    cand_tau = torch.cat([torch.zeros_like(a), tmax, roots], dim=-1)
    idx = torch.argmin(cand_f, dim=-1, keepdim=True)
    return torch.gather(cand_tau, -1, idx)[..., 0], root_num
