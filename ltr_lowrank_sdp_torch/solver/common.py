"""Shared solver machinery: factors, gradients, DIMACS metrics, host reads.

The port of ``ltr_lowrank_sdp_tpu/solver/common.py``.  The solver variables
are tuples of per-cone (n_k, r_k) float64 factor tensors on the device, plus
an optional (n_lp,) LP factor vector.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.scalars import smul
from ..problem import SDPProblem

Factors = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class ProblemConsts:
    """Problem norms used by the DIMACS scaling."""

    m: int
    b_nrm1: float
    b_nrm2: float
    b_nrminf: float
    c_nrm1: float
    c_nrm2: float
    c_nrminf: float

    @staticmethod
    def from_problem(prob: SDPProblem) -> "ProblemConsts":
        return ProblemConsts(
            m=prob.m,
            b_nrm1=prob.b_nrm1, b_nrm2=prob.b_nrm2, b_nrminf=prob.b_nrminf,
            c_nrm1=prob.c_nrm1, c_nrm2=prob.c_nrm2, c_nrminf=prob.c_nrminf,
        )


class HostSync:
    """Brings device scalars to the host and counts how often it did.

    Every control decision of the solver that depends on a device value
    goes through one call: in the eager loops one a decision, in the
    device-resident loops (:mod:`.devloop`) one a chunk, whose ``replays``
    of CUDA graphs are counted beside it; ``graphs`` lists each captured
    graph's (name, nodes, instantiation ms).  ``count`` is the number of
    device->host synchronizations a solve made.  (On the CPU the device
    loops' driver reads each predicate as well, free there and not
    counted.)"""

    def __init__(self):
        self.count = 0
        self.replays = 0
        self.graphs: List[Tuple[str, int, float]] = []

    def __call__(self, *xs) -> List[float]:
        self.count += 1
        if len(xs) == 1 and xs[0].dim() == 0:
            return [xs[0].item()]
        return torch.stack([x.reshape(()) for x in xs]).tolist()

    def flat(self, *xs) -> List[float]:
        """One read of several tensors of any shapes, concatenated."""
        self.count += 1
        return torch.cat([x.reshape(-1) for x in xs]).tolist()


def own_flags(*flags: bool) -> Tuple[bool, ...]:
    """The stop decisions (time up, interrupted) of a solve on one rank: its
    own, as read.  A sharded solve combines them over its ranks instead
    (``Mesh.agree``)."""
    return tuple(bool(f) for f in flags)


def flatten_factors(R: Factors, rlp=None) -> torch.Tensor:
    """One vector of all factors, cone by cone, the LP vector last (the
    order fixes the rounding of the L-BFGS dot products)."""
    parts = [r.reshape(-1) for r in R]
    if rlp is not None:
        parts.append(rlp.reshape(-1))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def unflatten_factors(flat: torch.Tensor, shapes, has_lp: bool = False):
    """``(factors, rlp)``; ``rlp`` is None without an LP cone."""
    out = []
    idx = 0
    for shp in shapes:
        size = int(np.prod(shp))
        out.append(flat[idx: idx + size].reshape(shp))
        idx += size
    return tuple(out), (flat[idx:] if has_lp else None)


def init_factors(ranks: Sequence[int], dims: Sequence[int], n_lp: int,
                 generator: torch.Generator, device,
                 dtype=torch.float64):
    """``(R, rlp)``: difference of two uniforms on [0, 1) per entry (the
    distribution of ``LORADS_RANDOM_rk_MAT``, ``lorads_solver.c:527``), the
    LP start vector drawn last.  Drawn on the CPU generator and then moved,
    so a seed gives the same factors on every device."""
    def draw(shape):
        a = torch.rand(shape, generator=generator, dtype=dtype)
        b = torch.rand(shape, generator=generator, dtype=dtype)
        return (a - b).to(device)

    R = tuple(draw((n, r)) for n, r in zip(dims, ranks))
    return R, (draw((n_lp,)) if n_lp > 0 else None)


def pad_rank_columns(F: torch.Tensor, new_rank: int) -> torch.Tensor:
    """Grow a factor to new_rank columns, padding with the 1/sqrt(r) scaled
    identity of the reference escalation (``lpRandomDiag``,
    ``lorads_solver.c:1096-1106``)."""
    n, old = F.shape
    aug = new_rank - old
    if aug <= 0:
        return F
    r = min(n, aug)
    pad = torch.zeros((n, aug), dtype=F.dtype, device=F.device)
    idx = torch.arange(r, device=F.device)
    pad[idx, idx] = float(1.0 / np.sqrt(r))
    return torch.cat([F, pad], dim=1)


# --------------------------------------------------------------------------- #
# gradient / DIMACS
# --------------------------------------------------------------------------- #


def alm_gradient(cones, lp, R: Factors, rlp, dual, constr_sum, b, rho,
                 obj_scale: float, CR: Factors, red=None):
    """grad of L_rho = 2 (obj_scale*C + A*(w)) R, w = -lambda + rho(A(X)-b)
    (``ALMSetGrad``, ``lorads_alm.c:32-61``), with the objective term taken
    from the carried C·R; the LP factor's gradient is 2 (obj_scale*c +
    A_lp^T w) o r_lp.  ``rho``: a host float or a 0-dim device tensor.
    Returns (grads, grad_lp, ||grad||^2 as a 0-dim tensor); with ``red``
    (a row-sharded solve's ``RowReduce``) the norm is combined over the
    ranks, the LP factor's share counted once."""
    w = -dual + smul(rho, constr_sum - b)
    grads = tuple(
        2.0 * (obj_scale * cr + ops.apply_w(w, r, include_obj=False))
        for ops, r, cr in zip(cones, R, CR))
    norm_sq = sum(torch.dot(g.reshape(-1), g.reshape(-1)) for g in grads)
    grad_lp = None
    if lp is not None and rlp is not None:
        grad_lp = 2.0 * lp.weighted_col_sums(w, obj_coef=obj_scale) * rlp
        lp_sq = torch.dot(grad_lp, grad_lp)
        norm_sq = norm_sq + (lp_sq if red is None else red.rep(lp_sq))
    if red is not None:
        norm_sq = red.sum(norm_sq)
    return grads, grad_lp, norm_sq


def primal_infeas_l1(constr_sum, b, b_nrm1: float, red=None
                     ) -> torch.Tensor:
    """||b - A(X)||_2 / (1 + ||b||_1), the reference's 'L1' DIMACS error
    (``primalInfeasibility``, ``lorads_alg_common.c:386-394``); ``red``
    combines a row-sharded constraint vector's norm."""
    nrm = torch.linalg.vector_norm(b - constr_sum)
    if red is not None:
        nrm = red.reduce((), [red.own_m(nrm)])[1][0]
    return nrm / (1.0 + b_nrm1)


def host_metrics_f64(prob, U, V, ulp, vlp, dual, obj_scale: float):
    """Final DIMACS metrics recomputed in float64 numpy on the host from the
    problem's own COO data (original row and constraint order).

    Returns (pobj, dobj, pinf_l1, pinf_inf, gap)."""
    m = prob.m
    cvals = np.zeros(m)
    pobj = 0.0
    for cone, u, v in zip(prob.cones, U, V):
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        e = 0.5 * (np.sum(u[cone.c_rows] * v[cone.c_cols], axis=1)
                   + np.sum(u[cone.c_cols] * v[cone.c_rows], axis=1))
        mult = np.where(cone.c_rows != cone.c_cols, 2.0, 1.0)
        pobj += float(np.sum(mult * cone.c_vals * e))
        if cone.kind_a == "diag":
            de = np.sum(u[cone.diag_idx] * v[cone.diag_idx], axis=1)
            np.add.at(cvals, cone.diag_cid, cone.diag_val * de)
        else:
            ae = 0.5 * (np.sum(u[cone.a_rows] * v[cone.a_cols], axis=1)
                        + np.sum(u[cone.a_cols] * v[cone.a_rows], axis=1))
            amult = np.where(cone.a_rows != cone.a_cols, 2.0, 1.0)
            np.add.at(cvals, cone.a_cid, amult * cone.a_vals * ae)
    if prob.lp is not None and ulp is not None:
        x = np.asarray(ulp, np.float64) * np.asarray(vlp, np.float64)
        pobj += float(prob.lp.c @ x)
        np.add.at(cvals, prob.lp.cid, prob.lp.vals * x[prob.lp.col])

    b = np.asarray(prob.b, np.float64)
    dual64 = np.asarray(dual, np.float64)
    dobj = float(b @ dual64) / float(obj_scale)
    resid = b - cvals
    pinf_l1 = float(np.linalg.norm(resid)) / (1.0 + prob.b_nrm1)
    pinf_inf = pinf_l1 * (1.0 + prob.b_nrm1) / (1.0 + prob.b_nrminf)
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return pobj, dobj, pinf_l1, pinf_inf, gap
