"""Matrix-free conjugate gradients for the ADMM normal equations.

The port of ``ltr_lowrank_sdp_tpu/ops/cg.py`` (reference ``CGSolve``,
``linalg/lorads_cgs.c:128-290``) as an eager loop with the same semantics:

* warm start from the previous factor;
* relative-residual stop ``||r||_2 / ||b||_1 < tol`` (the reference's bNorm
  is an L1 norm, ``lorads_cgs.c:161``);
* residual recomputed from scratch every ``restart_freq`` steps;
* the iteration count is returned for the cgIter statistics.

:func:`cg_solve` reads one scalar (the stopping ratio) on the host each
iteration: the eager loop of the sharded and batched modes and the tests'
reference.  :func:`cg_device` is the same iteration as a body of device
tensors under a flow (``solver/devloop.py``): a WHILE node on the card, the
periodic restart an IF node, the float32 guard's best iterate kept with
selects; on the CPU (``HostFlow``) it gives :func:`cg_solve`'s bits.

float32 adds a safeguard that the reference lacks (a deviation, see
``ROADMAP.md``).  The ADMM asks for a relative residual of
min(pinf * 1e-2, 1e-8), which float32 often cannot reach; the reference's
CG then keeps iterating on rounding noise, and its recurrence can diverge
(on the multi-block + LP family the residual climbs from 4e-9 to 1e-2 in
800 iterations and the next ADMM iteration is NaN, in both packages).  In
float32 the solve therefore stops once its residual ratio has set no new
minimum for ``2 * restart_freq`` iterations, and returns the iterate of the
smallest residual ratio it saw.  A solve that converges never reaches
either rule, so it is the reference's.
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
             read: Callable = _read_one, red=None) -> CGResult:
    """Solve ``M x = b`` from ``x0``; ``read(t) -> [float(t)]`` brings one
    0-dim tensor to the host (the caller's sync counter).  ``red``: a
    row-sharded solve's :class:`~..parallel.rowshard.RowReduce` (the
    vectors are this rank's rows), which combines each step's sums in one
    collective."""
    bnorm1 = torch.sum(torch.abs(b))

    x = x0
    r = b - matvec(x0)
    p = r
    res_t = torch.linalg.vector_norm(r)
    if red is not None:
        (bnorm1,), (res_t,) = red.reduce([bnorm1], [res_t])
    bnorm1 = torch.where(bnorm1 == 0.0, torch.ones_like(bnorm1), bnorm1)
    ratio = read(res_t / bnorm1)[0]
    k = 0
    guard = b.dtype == torch.float32
    best_x, best_ratio, best_k = x, ratio, 0
    while ratio >= tol and k < max_iter:
        if guard and k - best_k >= 2 * restart_freq:
            break
        Q = matvec(p)
        qtr_cur = torch.dot(r.reshape(-1), r.reshape(-1))
        ptq = torch.dot(p.reshape(-1), Q.reshape(-1))
        if red is not None:
            (qtr_cur, ptq), _ = red.reduce([qtr_cur, ptq])
        alpha = qtr_cur / ptq
        x = x + alpha * p
        r = r - alpha * Q
        if (k + 1) % restart_freq == 0:
            # periodic residual recomputation for numerical hygiene
            r = b - matvec(x)
        qtr_new = torch.dot(r.reshape(-1), r.reshape(-1))
        res_t = torch.linalg.vector_norm(r)
        if red is not None:
            (qtr_new,), (res_t,) = red.reduce([qtr_new], [res_t])
        beta = qtr_new / qtr_cur
        p = r + beta * p
        k += 1
        ratio = read(res_t / bnorm1)[0]
        if guard and ratio < best_ratio:
            best_x, best_ratio, best_k = x, ratio, k
    if guard and not ratio <= best_ratio:
        x, ratio = best_x, best_ratio
    return CGResult(x=x, iters=k, resid=float(ratio),
                    converged=ratio < tol)


def cg_device(flow, matvec: Callable, b: torch.Tensor, x0: torch.Tensor,
              tol: torch.Tensor, max_iter: int, restart_freq: int = 20):
    """:func:`cg_solve` under ``flow`` with no host read: returns
    ``(x, iters)``, ``iters`` a 0-dim int64 tensor.  ``tol`` is a 0-dim
    float64 tensor; the stopping ratio keeps ``b``'s type, as the value
    :func:`cg_solve` reads."""
    bnorm1 = torch.sum(torch.abs(b))
    bnorm1 = torch.where(bnorm1 == 0.0, torch.ones_like(bnorm1), bnorm1)
    x = x0.clone()
    r = b - matvec(x0)
    p = r.clone()
    ratio = torch.linalg.vector_norm(r) / bnorm1
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    guard = b.dtype == torch.float32
    if guard:
        best_x, best_ratio = x.clone(), ratio.clone()
        best_k = torch.zeros_like(k)

    def go():
        g = (ratio >= tol) & (k < max_iter)
        if guard:
            g = g & (k - best_k < 2 * restart_freq)
        return g

    def restart():
        # periodic residual recomputation for numerical hygiene
        r.copy_(b - matvec(x))

    def step():
        Q = matvec(p)
        qtr_cur = torch.dot(r.reshape(-1), r.reshape(-1))
        ptq = torch.dot(p.reshape(-1), Q.reshape(-1))
        alpha = qtr_cur / ptq
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * Q)
        flow.if_(torch.remainder(k + 1, restart_freq) == 0, restart)
        qtr_new = torch.dot(r.reshape(-1), r.reshape(-1))
        beta = qtr_new / qtr_cur
        p.copy_(r + beta * p)
        res_t = torch.linalg.vector_norm(r)
        k.add_(1)
        ratio.copy_(res_t / bnorm1)
        if guard:
            better = ratio < best_ratio
            best_x.copy_(torch.where(better, x, best_x))
            best_ratio.copy_(torch.where(better, ratio, best_ratio))
            best_k.copy_(torch.where(better, k, best_k))

    flow.while_(go, step)
    if guard:
        x = torch.where(ratio <= best_ratio, x, best_x)
    return x, k
