"""Limited-memory BFGS two-loop recursion over flattened factor stacks.

The port of ``ltr_lowrank_sdp_tpu/ops/lbfgs.py`` (reference
``lorads_alm.c:347-599``, ``setlbfgsHisTwo:842``).  The history is a ring
buffer of preallocated (L, N) device tensors written in place; the ring
pointer and the pair count are host integers, so the recursion loops only
over valid pairs and needs no host read.  H0 = I, and the direction falls
back to -grad when the two-loop output is not a descent direction
(``LBFGSDirectionUseGrad``, ``lorads_alm.c:607``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LBFGSHistory:
    s: torch.Tensor       # (L, N) steps
    y: torch.Tensor       # (L, N) gradient differences
    beta: torch.Tensor    # (L,) 1/<y,s> (0 for a rejected pair)
    head: int = 0         # next slot to write
    count: int = 0        # number of valid pairs (saturates at L)


def init_history(n_elems: int, length: int, device,
                 dtype=torch.float64) -> LBFGSHistory:
    return LBFGSHistory(
        s=torch.zeros((length, n_elems), dtype=dtype, device=device),
        y=torch.zeros((length, n_elems), dtype=dtype, device=device),
        beta=torch.zeros((length,), dtype=dtype, device=device))


def push_pair(hist: LBFGSHistory, s: torch.Tensor, y: torch.Tensor) -> None:
    """Insert (s, y) at the ring head, in place.

    Cautious update: a pair with vanishing curvature <y,s> gets beta = 0,
    which makes it an exact no-op in both recursion loops."""
    ys = torch.dot(y, s)
    curv_ok = ys > 1e-8 * torch.linalg.vector_norm(y) * torch.linalg.vector_norm(s)
    beta = torch.where(curv_ok, 1.0 / torch.where(curv_ok, ys,
                                                  torch.ones_like(ys)),
                       torch.zeros_like(ys))
    L = hist.s.shape[0]
    hist.s[hist.head].copy_(s)
    hist.y[hist.head].copy_(y)
    hist.beta[hist.head] = beta
    hist.head = (hist.head + 1) % L
    hist.count = min(hist.count + 1, L)


def direction(hist: LBFGSHistory, grad: torch.Tensor,
              n_valid=None) -> torch.Tensor:
    """Two-loop recursion: D = -H grad, with -grad fallback on non-descent.

    ``n_valid`` limits the usable pairs (the reference's ``clearLBFGS``)."""
    L = hist.s.shape[0]
    n_use = hist.count if n_valid is None else min(n_valid, hist.count)
    q = grad
    alphas = {}
    for k in range(n_use):                      # newest -> oldest
        slot = (hist.head - 1 - k) % L
        alpha = hist.beta[slot] * torch.dot(hist.s[slot], q)
        q = q - alpha * hist.y[slot]
        alphas[slot] = alpha
    for k in range(n_use):                      # oldest -> newest
        slot = (hist.head - 1 - (n_use - 1 - k)) % L
        w = alphas[slot] - hist.beta[slot] * torch.dot(hist.y[slot], q)
        q = q + w * hist.s[slot]
    D = -q
    if n_use == 0:
        return -grad
    descent = torch.dot(D, grad) < 0.0
    return torch.where(descent, D, -grad)
