"""Batched-instance ALM steps with the batch split over the mesh.

The port of ``ltr_lowrank_sdp_tpu/parallel/batch.py``.  Instances that
share one constraint structure (MaxCut instances of one family and size:
diagonal constraints ``diag(X) = b``, each its own sparse objective) are
stacked along a leading axis; the axis is split over the mesh's ``batch``
groups, each rank steps its contiguous share of the instances with no
communication, and the result is gathered back to the full (B, ...)
tensors on every rank (the JAX result's logical shape).

Where the JAX step ``vmap``s an XLA scatter-add for C·Y
(``batch.py:76-81``), the port stacks its instances into one
block-diagonal symmetric CSR and runs K1 (``spmm_sym_csr``) once for all of
them, the C·Y + w∘Y of the gradient in one launch; the diagonal constraints
are K2 (``diag_rowdot``); the per-instance objective is plain torch.  The
B exact quartic line searches run on the device (:func:`quartic_argmin_t`),
so ``num_steps`` steps make no host read, as the JAX ``fori_loop`` makes
none.

Heterogeneous instances are padded to a common (n, nnz) envelope by
:func:`batched_from_problems` (zero-valued entries change nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels as K
from ..ops.cubic import quartic_argmin_t
from ..problem import SDPProblem


@dataclasses.dataclass
class BatchedMaxCutProblem:
    """A batch of MaxCut-family instances: diagonal constraints A_i = e_i
    e_i^T, a per-instance sparse objective given by its upper-triangle COO
    (duplicates add)."""

    c_rows: torch.Tensor    # (B, nnzC) int
    c_cols: torch.Tensor    # (B, nnzC) int
    c_vals: torch.Tensor    # (B, nnzC) per-instance values (0 padded)
    b: torch.Tensor         # (B, n)
    n: int


def batched_from_problems(probs: Sequence[SDPProblem],
                          dtype=torch.float64) -> BatchedMaxCutProblem:
    """Stack diag-cone problems into one batch, padding each objective with
    zero-valued (0, 0) entries."""
    cones = [p.cones[0] for p in probs]
    n = max(c.n for c in cones)
    nnz = max(c.c_vals.size for c in cones)
    B = len(probs)
    rows = np.zeros((B, nnz), np.int64)
    cols = np.zeros((B, nnz), np.int64)
    vals = np.zeros((B, nnz))
    b = np.zeros((B, n))
    for i, (p, c) in enumerate(zip(probs, cones)):
        k = c.c_vals.size
        rows[i, :k] = c.c_rows
        cols[i, :k] = c.c_cols
        vals[i, :k] = c.c_vals
        bi = np.zeros(n)
        np.add.at(bi, c.diag_idx, c.diag_val * 0 + p.b[c.diag_cid])
        b[i] = bi
    return BatchedMaxCutProblem(
        c_rows=torch.tensor(rows), c_cols=torch.tensor(cols),
        c_vals=torch.tensor(vals, dtype=dtype), b=torch.tensor(b, dtype=dtype),
        n=n)


class LocalBatch:
    """One rank's instances as flat (Bl * n)-row layouts on its device."""

    def __init__(self, prob: BatchedMaxCutProblem, lo: int, hi: int, device,
                 dtype):
        n = prob.n
        Bl = hi - lo
        off = (torch.arange(Bl) * n)[:, None]
        rows = (prob.c_rows[lo:hi].long() + off).reshape(-1)
        cols = (prob.c_cols[lo:hi].long() + off).reshape(-1)
        vals = prob.c_vals[lo:hi].reshape(-1).to(torch.float64)
        # every entry kept, duplicates included: the scatter-add they
        # replace adds each one
        self.csr = K.SymCSR.from_upper_coo(rows.numpy(), cols.numpy(),
                                           vals.numpy(), Bl * n, device,
                                           dtype)
        self.rows = rows.to(device)
        self.cols = cols.to(device)
        self.coef = torch.where(rows != cols, 2.0 * vals, vals).to(
            device=device, dtype=dtype)
        self.ones = torch.ones(Bl * n, dtype=dtype, device=device)
        self.b = prob.b[lo:hi].to(device=device, dtype=dtype)
        self.b_nrm1 = torch.sum(torch.abs(self.b), dim=1)
        self.Bl, self.n = Bl, n

    def obj(self, U, V):
        """Per-instance <C, sym(U V^T)> of flat (Bl * n, r) factors."""
        e = 0.5 * (torch.sum(U[self.rows] * V[self.cols], dim=-1)
                   + torch.sum(U[self.cols] * V[self.rows], dim=-1))
        return torch.sum((self.coef * e).view(self.Bl, -1), dim=1)

    def step(self, R, dual, rho: float):
        """One steepest-descent ALM step with the exact line search for
        every local instance (the JAX ``_single_alm_step``)."""
        Bl, n = self.Bl, self.n
        r = R.shape[-1]
        Rf = R.reshape(Bl * n, r)
        cons = K.diag_rowdot(Rf, Rf, self.ones).view(Bl, n)
        w = -dual + rho * (cons - self.b)
        D = -2.0 * K.spmm_sym_csr(self.csr, Rf, 1.0, d=w.reshape(-1))
        q0 = self.b - cons
        q1, q2 = K.diag_rowdot(Rf, D, self.ones, 2.0, second=True)
        q1, q2 = q1.view(Bl, n), q2.view(Bl, n)
        p1 = 2.0 * self.obj(Rf, D)
        p2 = self.obj(D, D)
        q0s = q0 + dual / rho
        a = rho * torch.sum(q2 * q2, dim=1) / 2.0
        bq = rho * torch.sum(q1 * q2, dim=1)
        c = (p2 - rho * torch.sum(q0s * q2, dim=1)
             + rho * torch.sum(q1 * q1, dim=1) / 2.0)
        d = p1 - rho * torch.sum(q0s * q1, dim=1)
        tau, _ = quartic_argmin_t(a, bq, c, d)
        R = R + tau[:, None, None] * D.view(Bl, n, r)
        cons = cons + tau[:, None] * q1 + (tau * tau)[:, None] * q2
        dual = dual + rho * (self.b - cons)
        pinf = torch.linalg.vector_norm(self.b - cons, dim=1) / (
            1.0 + self.b_nrm1)
        return R, dual, pinf


def _gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def local_alm_steps(prob: BatchedMaxCutProblem, lo: int, hi: int, R, dual,
                    rho: float, num_steps: int, device):
    """``num_steps`` ALM steps of instances lo..hi-1 on ``device``, no
    communication: R (hi - lo, n, r), dual (hi - lo, n).  Returns (R, dual,
    pinf) of the last step."""
    local = LocalBatch(prob, lo, hi, device, R.dtype)
    R = R.to(device).contiguous()
    dual = dual.to(device).contiguous()
    pinf = torch.zeros(hi - lo, dtype=R.dtype, device=device)
    for _ in range(num_steps):
        R, dual, pinf = local.step(R, dual, float(rho))
    return R, dual, pinf


def batched_alm_steps(mesh, prob: BatchedMaxCutProblem, R, dual,
                      rho: float, num_steps: int = 1):
    """Run ``num_steps`` batched ALM steps with the batch axis split over
    ``mesh``'s ``batch`` groups.

    R: (B, n, r), dual: (B, n), the same on every rank.  Returns (R, dual,
    pinf (B,)) of the last step, gathered on every rank, on ``mesh.device``.
    B must be a multiple of the batch axis."""
    Db = mesh.shape["batch"]
    B = int(R.shape[0])
    if B % Db:
        raise ValueError(f"batch axis {Db} does not divide {B} instances")
    i = mesh.coord("batch")
    lo, hi = i * B // Db, (i + 1) * B // Db
    Rl, dl, pinf = local_alm_steps(prob, lo, hi, R[lo:hi], dual[lo:hi], rho,
                                   num_steps, mesh.device)
    group = mesh.group("batch")
    return (_gather(Rl, group, Db), _gather(dl, group, Db),
            _gather(pinf, group, Db))
