"""Canonical problem representation (a copy of ``ltr_lowrank_sdp_tpu/problem.py``).

Converts raw :class:`~ltr_lowrank_sdp_torch.io.sdpa.SDPAData` into the
solver's per-cone operator data, choosing a compute path per cone:

* ``diag``  — every constraint in the cone is a single diagonal entry
  (MaxCut-like); A(X) and A*(w) become row-wise vector ops.  Mirrors the
  reference's ``detectMaxCutProb`` fast path (``lorads_solver.c:472-497``).
* ``sparse`` — constraints kept as stacked COO triplets; A(sym(UV^T)) is a
  gather + segment-sum, A*(w)·Y a weighted scatter-add (analog of the
  reference's sparse ``sdp_coeff``/w_sum path, ``lorads_sdp_data.c:750-843``).
* ``dense`` — the weighted sum S = obj·C + A*(w) is materialized as a dense
  n x n matrix.  Chosen with the same rule as the reference presolve (dense
  if dim < 20 or union sparsity ratio >= 0.1,
  ``lorads_sdp_conic.c:1201,1305-1392``), with an additional dimension cap
  since an n x n temporary must fit in memory.

The objective C has an independent dense/sparse choice (a dense C with sparse
constraints is common: Lovasz theta).  The classification is kept identical
to the JAX package so both build the same ``SDPProblem``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .io.sdpa import SDPAData, SDPABlock

DENSE_DIM_HARD_CAP = 4096   # never materialize S above this dimension
DENSE_SP_RATIO = 0.1        # reference presolve threshold
DENSE_SMALL_DIM = 20


@dataclasses.dataclass
class ConeData:
    """Host-side (numpy) operator data for one SDP cone."""

    n: int                       # block dimension
    m: int                       # number of global constraints
    # objective entries, upper triangle (row <= col), minimize <C, X>
    c_rows: np.ndarray
    c_cols: np.ndarray
    c_vals: np.ndarray
    # constraint entries
    a_rows: np.ndarray
    a_cols: np.ndarray
    a_vals: np.ndarray
    a_cid: np.ndarray            # global constraint id per entry
    kind_a: str                  # 'diag' | 'sparse' | 'dense'
    kind_c: str                  # 'sparse' | 'dense'
    n_active: int                # #constraints with entries in this cone
    active_cids: np.ndarray      # sorted unique constraint ids
    # diag fast path (kind_a == 'diag'): one entry per constraint
    diag_idx: Optional[np.ndarray] = None   # row index per active constraint
    diag_val: Optional[np.ndarray] = None
    diag_cid: Optional[np.ndarray] = None

    @property
    def rank_max(self) -> int:
        """Barvinok-Pataki style cap: min(floor(sqrt(2 m_active)) + 1, n).

        Reference: ``LORADSDetermineRank`` (``lorads_solver.c:406-459``) with
        ``nnzRows`` = number of nonzero constraint matrices in the cone.
        """
        return int(min(int(np.sqrt(2.0 * max(self.n_active, 1))) + 1, self.n))


@dataclasses.dataclass
class LPConeData:
    """LP (diagonal) cone: columns x_j >= 0 factored as x_j = u_j v_j."""

    n_cols: int
    m: int
    c: np.ndarray        # (n_cols,) objective coefficients
    col: np.ndarray      # entry -> LP column
    cid: np.ndarray      # entry -> constraint id
    vals: np.ndarray
    # per-column squared 2-norm of its constraint column (ADMM closed form,
    # lorads_admm.c:759-792)
    nrm2sq: np.ndarray


@dataclasses.dataclass
class SDPProblem:
    """A canonicalized multi-block SDP with optional LP cone.

        min <C, X>  s.t.  A(X) = b,  X = blkdiag(X_1..X_K) >= 0,  x_lp >= 0
    """

    m: int
    b: np.ndarray
    cones: List[ConeData]
    lp: Optional[LPConeData] = None
    name: str = ""

    # objective / RHS norms used by DIMACS scaling (cal_sdp_const,
    # lorads_solver.c:1546-1575); off-diagonal entries count twice.
    c_nrm1: float = 0.0
    c_nrm2: float = 0.0
    c_nrminf: float = 0.0
    b_nrm1: float = 0.0
    b_nrm2: float = 0.0
    b_nrminf: float = 0.0

    @property
    def n_cones(self) -> int:
        return len(self.cones)

    @property
    def block_dims(self) -> List[int]:
        return [c.n for c in self.cones]

    @property
    def n_lp_cols(self) -> int:
        return self.lp.n_cols if self.lp is not None else 0


def _classify_cone(blk: SDPABlock, m: int) -> ConeData:
    n = blk.dim
    active = np.unique(blk.a_cid) if blk.a_cid.size else np.zeros(0, np.int32)
    n_active = int(active.size)

    cone = ConeData(
        n=n, m=m,
        c_rows=blk.c_rows, c_cols=blk.c_cols, c_vals=blk.c_vals,
        a_rows=blk.a_rows, a_cols=blk.a_cols, a_vals=blk.a_vals,
        a_cid=blk.a_cid,
        kind_a="sparse", kind_c="sparse",
        n_active=n_active, active_cids=active.astype(np.int32),
    )

    # --- diag fast path: every constraint = one diagonal entry ---
    if blk.a_cid.size and n_active == blk.a_cid.size:
        if np.array_equal(blk.a_rows, blk.a_cols):
            cone.kind_a = "diag"
            order = np.argsort(blk.a_cid, kind="stable")
            cone.diag_idx = blk.a_rows[order].astype(np.int32)
            cone.diag_val = blk.a_vals[order].astype(np.float64)
            cone.diag_cid = blk.a_cid[order].astype(np.int32)
            return _classify_c(cone)

    # --- dense path decision for A*(w) (reference presolve rule) ---
    if n <= DENSE_DIM_HARD_CAP:
        # the union pattern of C and all A_i, counted on (row, col) keys
        # (the JAX package builds the same set from Python tuples)
        keys = np.concatenate([
            blk.a_rows.astype(np.int64) * n + blk.a_cols,
            blk.c_rows.astype(np.int64) * n + blk.c_cols])
        sp_ratio = 2.0 * np.unique(keys).size / (n * (n + 1))
        if n < DENSE_SMALL_DIM or sp_ratio >= DENSE_SP_RATIO:
            cone.kind_a = "dense"
    return _classify_c(cone)


def _classify_c(cone: ConeData) -> ConeData:
    n = cone.n
    if n <= DENSE_DIM_HARD_CAP and cone.c_vals.size:
        ratio = 2.0 * cone.c_vals.size / (n * (n + 1))
        if n < DENSE_SMALL_DIM or ratio >= DENSE_SP_RATIO or cone.kind_a == "dense":
            cone.kind_c = "dense"
    return cone


def _sym_norms(rows, cols, vals):
    """(nrm1, nrm2, nrminf) of a symmetric matrix given triangle entries."""
    off = (rows != cols)
    mult = np.where(off, 2.0, 1.0)
    nrm1 = float(np.sum(mult * np.abs(vals)))
    nrm2sq = float(np.sum(mult * vals * vals))
    nrminf = float(np.max(np.abs(vals))) if vals.size else 0.0
    return nrm1, nrm2sq, nrminf


def canonicalize(data: SDPAData, name: str = "") -> SDPProblem:
    """Build the canonical problem from parsed SDPA data."""
    m = data.n_constrs
    cones = [_classify_cone(blk, m) for blk in data.blocks]

    lp = None
    if data.n_lp_cols > 0:
        nrm2sq = np.zeros(data.n_lp_cols)
        np.add.at(nrm2sq, data.lp_col, data.lp_vals**2)
        lp = LPConeData(
            n_cols=data.n_lp_cols, m=m,
            c=data.lp_c, col=data.lp_col, cid=data.lp_cid, vals=data.lp_vals,
            nrm2sq=nrm2sq,
        )

    prob = SDPProblem(m=m, b=data.b.copy(), cones=cones, lp=lp, name=name)

    nrm1 = 0.0
    nrm2sq = 0.0
    nrminf = 0.0
    for c in cones:
        a, b2, inf = _sym_norms(c.c_rows, c.c_cols, c.c_vals)
        nrm1 += a
        nrm2sq += b2
        nrminf = max(nrminf, inf)
    if lp is not None:
        nrm1 += float(np.sum(np.abs(lp.c)))
        nrm2sq += float(np.sum(lp.c**2))
        nrminf = max(nrminf, float(np.max(np.abs(lp.c))) if lp.c.size else 0.0)
    prob.c_nrm1 = nrm1
    prob.c_nrm2 = float(np.sqrt(nrm2sq))
    prob.c_nrminf = nrminf
    prob.b_nrm1 = float(np.sum(np.abs(prob.b)))
    prob.b_nrm2 = float(np.linalg.norm(prob.b))
    prob.b_nrminf = float(np.max(np.abs(prob.b))) if prob.b.size else 0.0
    return prob


def load_problem(path: str, name: str = "") -> SDPProblem:
    if not name:
        import os

        name = os.path.splitext(os.path.basename(path))[0]
        if name.endswith(".dat"):
            name = name[:-4]
    if path.endswith(".mat"):
        from .io.maxcut import load_maxcut_mat

        return load_maxcut_mat(path, name=name)
    from .io.sdpa import read_sdpa

    return canonicalize(read_sdpa(path), name=name)


def initial_ranks(
    prob: SDPProblem,
    times_log_rank: float = 2.0,
    fixed_rank: int = -1,
    init_rank: int = -1,
) -> tuple[List[int], List[int]]:
    """Initial rank and rank cap per cone.

    Mirrors ``LORADSDetermineRank`` (``lorads_solver.c:406-459``):
    fixed_rank freezes both; init_rank seeds a dynamic run; otherwise dense
    smallish single-block problems start at rank_max and everything else at
    ``ceil(times_log_rank * log n)`` capped by rank_max.
    """
    ranks: List[int] = []
    rank_caps: List[int] = []
    n_cones = prob.n_cones
    for cone in prob.cones:
        cap = cone.rank_max
        if fixed_rank > 0:
            r = max(1, min(fixed_rank, cone.n))
            ranks.append(r)
            rank_caps.append(r)
            continue
        rank_caps.append(cap)
        if init_rank > 0:
            ranks.append(max(1, min(init_rank, cone.n)))
        elif times_log_rank <= 1e-6:
            ranks.append(max(1, cap))
        elif (
            cone.n_active / max(cone.n, 1) >= 20
            and cone.n <= 400
            and n_cones <= 3
        ):
            ranks.append(max(1, cap))
        else:
            r = int(min(np.ceil(times_log_rank * np.log(max(cone.n, 2))), cap))
            ranks.append(max(1, r))
    return ranks, rank_caps
