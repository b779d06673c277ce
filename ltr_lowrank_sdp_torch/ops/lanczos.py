"""Lanczos extremal-eigenvalue estimation (the ARPACK replacement).

The port of ``ltr_lowrank_sdp_tpu/ops/lanczos.py``.  The reference certifies
dual feasibility with ARPACK's implicitly-restarted Lanczos (which="SA", tol
1e-2, ``lorads_sdp_conic.c:1636-1699``); here a fixed-iteration Lanczos with
full reorthogonalization runs on the device, the k x k tridiagonal is
eigendecomposed on the host.  The start vector is an explicit argument, so a
caller (or a test) decides where it comes from.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def lanczos_tridiag(matvec: Callable, n: int, v0: torch.Tensor,
                    num_iters: int = 64, red=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-step Lanczos with full reorthogonalization from start vector ``v0``
    (normalized here).  Returns the device tensors ``(alphas, betas)`` of the
    k x k tridiagonal, ``betas[j]`` the subdiagonal between j and j+1; no
    host read happens inside the loop.  ``red``: a row-sharded solve's
    :class:`~..parallel.rowshard.RowReduce` (``v0`` and the basis are this
    rank's rows of the n-vectors), which combines every dot and norm."""
    k = min(num_iters, n)
    dot = torch.dot if red is None else red.dot
    norm = torch.linalg.vector_norm if red is None else red.norm
    v = v0 / norm(v0)
    V = torch.zeros((k, v0.shape[0]), dtype=v0.dtype, device=v0.device)
    V[0] = v
    alphas = torch.zeros((k,), dtype=v0.dtype, device=v0.device)
    betas = torch.zeros((k,), dtype=v0.dtype, device=v0.device)
    for j in range(k):
        v = V[j]
        w = matvec(v)
        alpha = dot(v, w)
        w = w - alpha * v
        if j > 0:
            w = w - betas[j - 1] * V[j - 1]
        # full reorthogonalization against v_0 .. v_j
        Vj = V[: j + 1]
        proj = Vj @ w
        if red is not None:
            proj = red.sum(proj)
        w = w - proj @ Vj
        beta = norm(w)
        alphas[j] = alpha
        betas[j] = beta
        if j + 1 < k:
            safe = torch.where(beta > 1e-30, beta, torch.ones_like(beta))
            V[j + 1] = w / safe
    return alphas, betas


def lanczos_min_eig_vec(matvec: Callable, n: int, v0: torch.Tensor,
                        num_iters: int = 64) -> Tuple[float, np.ndarray]:
    """Minimum eigenvalue AND Ritz vector of the symmetric operator
    ``matvec`` (HALLaR's escape direction), from start vector ``v0``.

    The recurrence of ``ltr_lowrank_sdp_tpu/ops/lanczos.py``
    ``lanczos_min_eig_vec`` (:115-159), which differs from
    :func:`lanczos_tridiag`: no three-term ``beta`` subtraction, only the
    full reorthogonalization against the basis so far (rows past ``j`` of V
    are still zero, as the reference's mask makes them).  The loop runs on
    ``v0``'s device with no host read; the basis, the k x k tridiagonal's
    eigendecomposition and the Ritz vector come to the host in one read and
    are combined there in float64.  Returns ``(lambda_min, ritz)`` with
    ``ritz`` a unit float64 numpy vector."""
    k = min(num_iters, n)
    V = torch.zeros((k, n), dtype=v0.dtype, device=v0.device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    alphas = torch.zeros((k,), dtype=v0.dtype, device=v0.device)
    betas = torch.zeros((k,), dtype=v0.dtype, device=v0.device)
    for j in range(k):
        v = V[j]
        w = matvec(v)
        alpha = torch.dot(v, w)
        w = w - alpha * v
        w = w - (V @ w) @ V
        beta = torch.linalg.vector_norm(w)
        alphas[j] = alpha
        betas[j] = beta
        if j + 1 < k:
            V[j + 1] = w / torch.where(beta > 1e-30, beta,
                                       torch.ones_like(beta))
    host = torch.cat([alphas, betas, V.reshape(-1)]).cpu().numpy()
    a = np.asarray(host[:k], np.float64)
    bta = np.asarray(host[k:2 * k], np.float64)
    T = np.diag(a) + np.diag(bta[: k - 1], 1) + np.diag(bta[: k - 1], -1)
    evals, evecs = np.linalg.eigh(T)
    ritz = np.asarray(host[2 * k:], np.float64).reshape(k, n).T @ evecs[:, 0]
    nrm = np.linalg.norm(ritz)
    if nrm > 0:
        ritz = ritz / nrm
    return float(evals[0]), ritz


def tridiag_min_eig_resid(alphas, betas) -> Tuple[float, float]:
    """Smallest eigenvalue of the k x k tridiagonal AND its Lanczos residual
    bound ``|beta_k * u[k-1]|`` (Paige), on the host in float64."""
    a = np.asarray(alphas, np.float64)
    bta = np.asarray(betas, np.float64)
    k = a.shape[0]
    T = np.diag(a) + np.diag(bta[: k - 1], 1) + np.diag(bta[: k - 1], -1)
    evals, evecs = np.linalg.eigh(T)
    resid = float(abs(bta[k - 1] * evecs[k - 1, 0]))
    return float(evals[0]), resid


def oracle_rank_gram(factor, eps: float = 1e-6) -> int:
    """Numerical rank of X = F F^T from the r x r Gram spectrum: the number
    of eigenvalues > eps * lambda_max (``count_significant_from_matrix``,
    ``lorads_logging.c:272-400``).  The Gram is a plain product; its
    eigendecomposition runs on the host."""
    if isinstance(factor, torch.Tensor):
        G = (factor.T @ factor).cpu().numpy()
    else:
        F = np.asarray(factor, np.float64)
        G = F.T @ F
    evals = np.linalg.eigvalsh(np.asarray(G, np.float64))
    lam_max = evals[-1]
    if lam_max <= 0:
        return 0
    return int(np.sum(evals > eps * lam_max))


def oracle_rank_naive(factor, eps: float = 1e-6, dim_cap: int = 2000) -> int:
    """Full-matrix oracle rank; the Gram method for n > cap
    (reference ``lorads_logging.c:406-451``)."""
    n = factor.shape[0]
    if n > dim_cap:
        return oracle_rank_gram(factor, eps)
    F = (factor.cpu().numpy() if isinstance(factor, torch.Tensor)
         else np.asarray(factor))
    F = np.asarray(F, np.float64)
    evals = np.linalg.eigvalsh(F @ F.T)
    lam_max = evals[-1]
    if lam_max <= 0:
        return 0
    return int(np.sum(evals > eps * lam_max))
