"""Limited-memory BFGS two-loop recursion over flattened factor stacks.

The port of ``ltr_lowrank_sdp_tpu/ops/lbfgs.py`` (reference
``lorads_alm.c:347-599``, ``setlbfgsHisTwo:842``).  The history is a ring
buffer of preallocated (L, N) device tensors written in place.  H0 = I, and
the direction falls back to -grad when the two-loop output is not a descent
direction (``LBFGSDirectionUseGrad``, ``lorads_alm.c:607``).

Two forms of the same recursion:

* :func:`push_pair` / :func:`direction` keep the ring pointer and the pair
  count as host integers and loop only over the valid pairs (the eager ALM
  loop);
* :func:`push_pair_t` / :func:`direction_t` keep them as 0-dim device
  tensors (:class:`DeviceRing`) and loop over all L slots, an invalid slot
  an exact no-op (its update selected away), as the JAX package's
  ``fori_loop`` does: the device-resident inner pass, whose captured steps
  cannot take a host integer that changes.  Both give the same bits.
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


def push_pair(hist: LBFGSHistory, s: torch.Tensor, y: torch.Tensor,
              red=None, head=None) -> None:
    """Insert (s, y) at the ring head, in place.

    Cautious update: a pair with vanishing curvature <y,s> gets beta = 0,
    which makes it an exact no-op in both recursion loops.  ``red``: a
    row-sharded solve's :class:`~..parallel.rowshard.RowReduce` (the
    vectors' first ``head`` entries are this rank's rows), which combines
    the three sums in one collective."""
    if red is None:
        ys = torch.dot(y, s)
        y_nrm = torch.linalg.vector_norm(y)
        s_nrm = torch.linalg.vector_norm(s)
    else:
        (ys,), (y_nrm, s_nrm) = red.reduce(
            [red.part_dot(y, s, head)],
            [red.part_norm(y, head), red.part_norm(s, head)])
    curv_ok = ys > 1e-8 * y_nrm * s_nrm
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
              n_valid=None, dot=torch.dot) -> torch.Tensor:
    """Two-loop recursion: D = -H grad, with -grad fallback on non-descent.

    ``n_valid`` limits the usable pairs (the reference's ``clearLBFGS``);
    ``dot`` is the inner product (a row-sharded solve's combines its
    ranks' partials)."""
    L = hist.s.shape[0]
    n_use = hist.count if n_valid is None else min(n_valid, hist.count)
    q = grad
    alphas = {}
    for k in range(n_use):                      # newest -> oldest
        slot = (hist.head - 1 - k) % L
        alpha = hist.beta[slot] * dot(hist.s[slot], q)
        q = q - alpha * hist.y[slot]
        alphas[slot] = alpha
    for k in range(n_use):                      # oldest -> newest
        slot = (hist.head - 1 - (n_use - 1 - k)) % L
        w = alphas[slot] - hist.beta[slot] * dot(hist.y[slot], q)
        q = q + w * hist.s[slot]
    D = -q
    if n_use == 0:
        return -grad
    descent = dot(D, grad) < 0.0
    return torch.where(descent, D, -grad)


@dataclasses.dataclass
class DeviceRing:
    """The ring pointer and pair count of an :class:`LBFGSHistory` as 0-dim
    int64 device tensors."""

    head: torch.Tensor
    count: torch.Tensor


def push_pair_t(hist: LBFGSHistory, ring: DeviceRing, s: torch.Tensor,
                y: torch.Tensor) -> None:
    """:func:`push_pair` with the ring on the device."""
    ys = torch.dot(y, s)
    curv_ok = ys > 1e-8 * torch.linalg.vector_norm(y) * torch.linalg.vector_norm(s)
    beta = torch.where(curv_ok, 1.0 / torch.where(curv_ok, ys,
                                                  torch.ones_like(ys)),
                       torch.zeros_like(ys))
    L = hist.s.shape[0]
    at = ring.head.reshape(1)
    hist.s.index_copy_(0, at, s.reshape(1, -1))
    hist.y.index_copy_(0, at, y.reshape(1, -1))
    hist.beta.index_copy_(0, at, beta.reshape(1))
    ring.head.copy_(torch.remainder(ring.head + 1, L))
    ring.count.copy_(torch.clamp(ring.count + 1, max=L))


def _slot(hist: LBFGSHistory, ring: DeviceRing, k: int):
    """(s, y, beta) of the k-th newest slot, gathered on the device."""
    at = torch.remainder(ring.head - 1 - k, hist.s.shape[0]).reshape(1)
    return (hist.s.index_select(0, at)[0], hist.y.index_select(0, at)[0],
            hist.beta.index_select(0, at)[0])


def direction_t(hist: LBFGSHistory, ring: DeviceRing, grad: torch.Tensor,
                n_valid: torch.Tensor) -> torch.Tensor:
    """:func:`direction` with the ring and ``n_valid`` on the device: every
    slot visited, the pairs past ``min(n_valid, count)`` selected away."""
    L = hist.s.shape[0]
    n_use = torch.minimum(n_valid, ring.count)
    q = grad
    alphas = []
    for k in range(L):                          # newest -> oldest
        s_k, y_k, b_k = _slot(hist, ring, k)
        alpha = b_k * torch.dot(s_k, q)
        q = torch.where(k < n_use, q - alpha * y_k, q)
        alphas.append(alpha)
    for k in reversed(range(L)):                # oldest -> newest
        s_k, y_k, b_k = _slot(hist, ring, k)
        w = alphas[k] - b_k * torch.dot(y_k, q)
        q = torch.where(k < n_use, q + w * s_k, q)
    D = -q
    descent = torch.dot(D, grad) < 0.0
    return torch.where((n_use > 0) & descent, D, -grad)
