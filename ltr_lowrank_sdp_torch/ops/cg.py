"""Matrix-free conjugate gradients for the ADMM normal equations.

The port of ``ltr_lowrank_sdp_tpu/ops/cg.py`` (reference ``CGSolve``,
``linalg/lorads_cgs.c:128-290``) as an eager loop with the same semantics:

* warm start from the previous factor;
* relative-residual stop ``||r||_2 / ||b||_1 < tol`` (the reference's bNorm
  is an L1 norm, ``lorads_cgs.c:161``);
* residual recomputed from scratch every ``restart_freq`` steps;
* the iteration count is returned for the cgIter statistics.

Each iteration reads one scalar (the stopping ratio) on the host.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resid: float
    converged: bool


def _read_one(t: torch.Tensor) -> List[float]:
    return [float(t)]


def cg_solve(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float,
             max_iter: int, restart_freq: int = 20,
             read: Callable = _read_one) -> CGResult:
    """Solve ``M x = b`` from ``x0``; ``read(t) -> [float(t)]`` brings one
    0-dim tensor to the host (the caller's sync counter)."""
    bnorm1 = torch.sum(torch.abs(b))
    bnorm1 = torch.where(bnorm1 == 0.0, torch.ones_like(bnorm1), bnorm1)

    x = x0
    r = b - matvec(x0)
    p = r
    res_t = torch.linalg.vector_norm(r)
    ratio = read(res_t / bnorm1)[0]
    k = 0
    while ratio >= tol and k < max_iter:
        Q = matvec(p)
        qtr_cur = torch.dot(r.reshape(-1), r.reshape(-1))
        ptq = torch.dot(p.reshape(-1), Q.reshape(-1))
        alpha = qtr_cur / ptq
        x = x + alpha * p
        r = r - alpha * Q
        if (k + 1) % restart_freq == 0:
            # periodic residual recomputation for numerical hygiene
            r = b - matvec(x)
        qtr_new = torch.dot(r.reshape(-1), r.reshape(-1))
        beta = qtr_new / qtr_cur
        p = r + beta * p
        res_t = torch.linalg.vector_norm(r)
        k += 1
        ratio = read(res_t / bnorm1)[0]
    return CGResult(x=x, iters=k, resid=float(ratio),
                    converged=ratio < tol)
