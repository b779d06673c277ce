"""Conic operators of the SDP cones and the LP cone on the device.

The port of ``ltr_lowrank_sdp_tpu/ops/coneops.py`` in float64 or float32
(the compute dtype of the solver): one :class:`ConeOps` per SDP block, one :class:`LPOps` for the LP cone, and the
whole-problem helpers.  A cone takes one of two constraint paths and one of
two objective paths.

**diag_identity constraints** — the MaxCut family: every constraint is one
diagonal entry and each row carries exactly one constraint (cf.
``detectMaxCutProb``, ``lorads_solver.c:472-497``).  The constraint space is
relabeled so constraint i lives on row i (``constr_order``), exactly as the
JAX package does, and only where it does: a single SDP cone and no LP cone
(the constraint space is shared between cones).  Then

* ``constr_vals`` / ``constr_vals_pair`` are row dots (kernel K2),
* ``cg_normal_matvec`` is a fused row operator (K3),
* ``apply_a`` is a row scale (K1's diagonal term).

**general constraints** — sparse constraint matrices (``kind_a`` ``"sparse"``
or ``"dense"``: as in the JAX package the dense kind keeps the sparse
constraint operators, only the objective changes) and a diag cone that is not
relabeled (the same operator with ``rows = cols = diag_idx``).  The
constraint space stays in the problem's order.  Then

* ``constr_vals`` / ``constr_vals_pair`` are the per-entry contraction fused
  with the per-constraint segment sum (K5),
* ``apply_a`` is the constraint-weighted SpMM over the symmetrized pattern
  (K6),
* ``cg_normal_matvec`` is K5 on ``(x, fixed)`` then K6 with the result as
  its weights, ``fixed`` as Y and ``x`` as the addend.

**sparse objective** — ``apply_c`` is the symmetric CSR SpMM (K1),
``obj_value`` one gathered contraction with a device-side sum (K4), and
``apply_w`` is one K1 launch under ``diag_identity`` (C and the row scale
together), else K1 then K6 accumulating onto it.

**dense objective** — whenever ``kind_c`` or ``kind_a`` is dense (Lovasz
theta, every small or densely coupled block) C is materialized as an (n, n)
tensor and ``apply_c``, the objective half of ``apply_w`` and ``obj_value``
(the two-sided ``cvdot`` average of the JAX package) are ``torch.matmul``
products, which the JAX package also computes outside any kernel; K6 then
accumulates A*(w) Y onto ``obj_coef * C @ Y``.  No CSR or COO of the n^2
objective is built.

**LP cone** — ``x_j = u_j v_j`` over nonnegative columns: ``constr_vals`` is
the segment sum over constraints (K7, with a pair mode for the ALM line
search), ``weighted_col_sums`` the segment sum over columns with the weight
gather inside (K8).

The JAX package also relabels the *vertex* space for its ELL layout
(``spmm_relabel_order``); the CSR kernels need no such order, so factor rows
stay in the problem's own order on every path.

**float32** — every layout carries float32 values and K1-K3 and K5-K8 load,
multiply and accumulate in float32, as XLA does on the TPU.  The objective
and the duality gap accumulate in float64 where the reference calls ``csum``
/ ``cvdot``: K4 (float64 products and sums, rounded back), the LP objective
and the dense-C ``obj_value``.  The dense-C products stay ``torch.matmul``
in full float32: a float32 ConeOps turns TF32 off for matrix products and
cuDNN (:func:`full_fp32_matmul`), since TF32 keeps about three decimal
digits where the solver needs float32's seven.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..problem import ConeData, LPConeData, SDPProblem
from . import kernels as K
from .compsum import cvdot



def full_fp32_matmul() -> None:
    """Keep float32 matrix products (and cuDNN) in full float32 on the card:
    no TF32.  Called for every float32 operator bundle."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class ConeOps:
    """Device-resident operator bundle for one SDP cone.

    ``constr_relabel`` grants the ``diag_identity`` relabeling of the
    constraint space (:func:`build_cone_ops_internal` does for a single cone
    with no LP cone)."""

    def __init__(self, cone: ConeData, device, dtype=torch.float64,
                 constr_relabel: bool = True):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"compute dtype {dtype}: float32 or float64")
        if dtype == torch.float32:
            full_fp32_matmul()
        n = cone.n
        self.n = n
        self.m = cone.m
        self.device = torch.device(device)
        self.dtype = dtype
        self.kind_a = cone.kind_a
        self.kind_c = cone.kind_c
        self.n_active = cone.n_active
        self.rank_max = cone.rank_max

        # ---- constraints ----
        self.diag_identity = False
        # diag_identity only: constr_order[i] is the original id of the
        # constraint at internal position i
        self.constr_order = None
        self.diag_val = None
        self.a_seg = self.a_csr = None      # general path: K5 / K6 layouts
        self.a_nnz = 0                      # entries of a non-diag cone
        if cone.kind_a == "diag":
            didx = np.asarray(cone.diag_idx, np.int64)
            dval = np.asarray(cone.diag_val, np.float64)
            dcid = np.asarray(cone.diag_cid, np.int64)
            if (constr_relabel and didx.size == n and cone.m == n
                    and np.unique(didx).size == n
                    and np.unique(dcid).size == n):
                # constraint i == row i
                by_row = np.argsort(didx)
                self.diag_identity = True
                self.constr_order = dcid[by_row]
                self.diag_val = torch.tensor(dval[by_row], dtype=dtype,
                                             device=self.device)
            else:
                self._build_general(didx, didx, dval, dcid)
        else:
            self._build_general(cone.a_rows, cone.a_cols, cone.a_vals,
                                cone.a_cid)
            self.a_nnz = int(np.asarray(cone.a_rows).size)

        # ---- objective C ----
        rows = np.asarray(cone.c_rows, np.int64)
        cols = np.asarray(cone.c_cols, np.int64)
        vals = np.asarray(cone.c_vals, np.float64)
        self.c_nnz = int(rows.size)
        # the JAX package materializes C under this rule (and counts its
        # GEMM in apply_flops even when C has no entry)
        self.dense_obj = cone.kind_c == "dense" or cone.kind_a == "dense"
        self.c_dense = None
        self.c_csr = None
        self.c_rows = self.c_cols = self.c_double_coef = None
        if self.dense_obj and self.c_nnz:
            C = np.zeros((n, n))
            np.add.at(C, (rows, cols), vals)
            off = rows != cols
            np.add.at(C, (cols[off], rows[off]), vals[off])
            self.c_dense = torch.tensor(C, dtype=dtype, device=self.device)
        elif self.c_nnz:
            # full symmetric CSR for K1, upper-triangle COO with off-diagonal
            # entries doubled for K4
            self.c_csr = K.SymCSR.from_upper_coo(rows, cols, vals, n,
                                                 self.device, dtype)
            self.c_rows = torch.tensor(rows, dtype=torch.int32,
                                       device=self.device)
            self.c_cols = torch.tensor(cols, dtype=torch.int32,
                                       device=self.device)
            self.c_double_coef = torch.tensor(
                np.where(rows != cols, 2.0 * vals, vals), dtype=dtype,
                device=self.device)

    def _build_general(self, rows, cols, vals, cid) -> None:
        """The two static layouts of the general path; none when the cone
        holds no constraint entry (the operators are then zero)."""
        if not np.asarray(rows).size:
            return
        self.a_seg = K.SegCOO.from_coo(rows, cols, vals, cid, self.n, self.m,
                                       self.device, self.dtype)
        self.a_csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, self.n,
                                                self.m, self.device,
                                                self.dtype)

    def _zeros_m(self):
        return torch.zeros(self.m, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------ #

    def constr_vals(self, U, V):
        """A(sym(U V^T)) -> (m,), zeros off-cone; in the internal constraint
        order under ``diag_identity``."""
        if self.diag_identity:
            return K.diag_rowdot(U, V, self.diag_val, 1.0)
        if self.a_seg is None:
            return self._zeros_m()
        return K.coo_contract_segsum(self.a_seg, U, V)

    def constr_vals_pair(self, R, D):
        """(A(2 sym(R D^T)), A(D D^T)) in one pass (the ALM line search)."""
        if self.diag_identity:
            return K.diag_rowdot(R, D, self.diag_val, 2.0, second=True)
        if self.a_seg is None:
            return self._zeros_m(), self._zeros_m()
        return K.coo_contract_segsum(self.a_seg, R, D, pair=True)

    def cg_normal_matvec(self, fixed):
        """The ADMM normal-equation operator
        ``x -> x + A*(A(sym(x fixed^T))) fixed`` (``linSysProduct``,
        ``lorads_admm.c:471-486``)."""
        if self.diag_identity:
            dv = self.diag_val
            return lambda x: K.diag_normal_matvec(x, fixed, dv)
        if self.a_seg is None:
            return lambda x: x
        seg, csr = self.a_seg, self.a_csr

        def mv(x):
            w = K.coo_contract_segsum(seg, x, fixed)
            return K.spmm_constr_csr(csr, w, fixed, Z=x, beta=1.0)

        return mv

    def obj_value(self, U, V):
        """<C, sym(U V^T)> as a 0-dim device tensor."""
        if not self.c_nnz:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        if self.c_dense is not None:
            # C symmetric: tr(C sym(U V^T)) = <U, C V>, averaged with its
            # transpose pair as the JAX package does (the two terms are the
            # same number when U is V, and x == 0.5 * (x + x) exactly)
            uv = cvdot(U, torch.matmul(self.c_dense, V))
            if U is V:
                return uv
            return 0.5 * (uv + cvdot(V, torch.matmul(self.c_dense, U)))
        # K4 sums in float64; rounded to the compute dtype like csum's
        return K.sym_contract_sum(self.c_rows, self.c_cols,
                                  self.c_double_coef, U, V).to(self.dtype)

    def apply_c(self, Y):
        """C @ Y."""
        if self.c_dense is not None:
            return torch.matmul(self.c_dense, Y)
        if self.c_csr is None:
            return torch.zeros_like(Y)
        return K.spmm_sym_csr(self.c_csr, Y, 1.0)

    def apply_a(self, w, Y):
        """A*(w) @ Y: a row scale by diag_val * w under ``diag_identity``,
        else the constraint-weighted SpMM."""
        if self.diag_identity:
            return K.spmm_sym_csr(None, Y, 0.0, d=self.diag_val, w=w)
        if self.a_csr is None:
            return torch.zeros_like(Y)
        return K.spmm_constr_csr(self.a_csr, w, Y)

    def apply_w(self, w, Y, obj_coef=1.0, include_obj=True):
        """(obj_coef * C + A*(w)) @ Y (``mul_rk``).  Sparse C: one kernel
        under ``diag_identity``, else K1 then K6 accumulating onto its
        output.  Dense C: the GEMM, then K6 accumulating onto it."""
        if not (include_obj and self.c_nnz):
            return self.apply_a(w, Y)
        if self.c_dense is not None:
            cy = float(obj_coef) * torch.matmul(self.c_dense, Y)
            if self.diag_identity:
                return self.apply_a(w, Y) + cy
        elif self.diag_identity:
            return K.spmm_sym_csr(self.c_csr, Y, float(obj_coef),
                                  d=self.diag_val, w=w)
        else:
            cy = K.spmm_sym_csr(self.c_csr, Y, float(obj_coef))
        if self.a_csr is None:
            return cy
        return K.spmm_constr_csr(self.a_csr, w, Y, Z=cy, beta=1.0)

    # flops of one evaluation (the ALM inner-pass cap derives from these,
    # as in the JAX package)
    def constr_flops(self, rank: int) -> int:
        if self.kind_a == "diag":
            return 2 * self.n_active * rank
        return 6 * self.a_nnz * rank

    def apply_flops(self, rank: int) -> int:
        obj = (2 * self.n * self.n * rank if self.dense_obj
               else 4 * self.c_nnz * rank)
        return 4 * self.a_nnz * rank + obj + 2 * self.n * rank


class LPOps:
    """LP cone operators: x_j = u_j v_j over nonnegative columns."""

    def __init__(self, lp: LPConeData, device, dtype=torch.float64):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"compute dtype {dtype}: float32 or float64")
        self.n_cols = lp.n_cols
        self.m = lp.m
        self.device = torch.device(device)
        self.dtype = dtype
        self.entries = K.LPEntries.from_coo(lp.c, lp.col, lp.cid, lp.vals,
                                            lp.m, lp.n_cols, self.device,
                                            dtype)
        self.c = self.entries.c
        self.nrm2sq = torch.tensor(np.asarray(lp.nrm2sq, np.float64),
                                   dtype=dtype, device=self.device)

    def constr_vals(self, u, v):
        """A_lp(diag(u v)) as a global (m,) vector (K7)."""
        return K.lp_constr_segsum(self.entries, u, v)

    def constr_vals_pair(self, r, d):
        """(2 A_lp(r o d), A_lp(d o d)) in one pass (the ALM line search)."""
        return K.lp_constr_segsum(self.entries, r, d, pair=True)

    def obj_value(self, u, v):
        return cvdot(self.c, u * v)

    def weighted_col_sums(self, w, obj_coef=1.0):
        """Per-column (obj_coef*c_j + sum_i w_i A_ij), the LP analog of
        C + A*(w) (K8)."""
        return K.lp_col_wsum(self.entries, w, float(obj_coef))


def build_cone_ops(prob: SDPProblem, device, dtype=torch.float64
                   ) -> Tuple[List[ConeOps], Optional[LPOps]]:
    """Operator bundles with every constraint in the problem's order."""
    cones = [ConeOps(c, device, dtype, constr_relabel=False)
             for c in prob.cones]
    lp = LPOps(prob.lp, device, dtype) if prob.lp is not None else None
    return cones, lp


def build_cone_ops_internal(prob: SDPProblem, device,
                            dtype=torch.float64
                            ) -> Tuple[List[ConeOps], Optional[LPOps],
                                       Optional[np.ndarray]]:
    """Operator bundles for the solver's internal state: ``(cones, lp,
    constr_order)``.  ``constr_order`` is None (constraints in the problem's
    order) or the (m,) map internal -> original constraint id; the caller
    then permutes ``b`` by it and un-permutes duals at egress.  The
    constraint relabeling is granted only to a single SDP cone with no LP
    cone (the constraint space is shared across cones)."""
    allow_constr = len(prob.cones) == 1 and prob.lp is None
    cones = [ConeOps(c, device, dtype, constr_relabel=allow_constr)
             for c in prob.cones]
    lp = LPOps(prob.lp, device, dtype) if prob.lp is not None else None
    constr_order = cones[0].constr_order if allow_constr and cones else None
    return cones, lp, constr_order


# --------------------------------------------------------------------------- #
# Whole-problem helpers
# --------------------------------------------------------------------------- #


def all_constr_vals(cones: List[ConeOps], lp: Optional[LPOps], U, V,
                    ulp=None, vlp=None):
    """Sum of per-cone A(sym(U_k V_k^T)) (+ LP part) -> (m,)."""
    ref = cones[0] if cones else lp
    out = torch.zeros(ref.m, dtype=ref.dtype, device=ref.device)
    for ops, u, v in zip(cones, U, V):
        out = out + ops.constr_vals(u, v)
    if lp is not None and ulp is not None:
        out = out + lp.constr_vals(ulp, vlp)
    return out


def all_obj_value(cones: List[ConeOps], lp: Optional[LPOps], U, V, ulp=None,
                  vlp=None):
    ref = cones[0] if cones else lp
    total = torch.zeros((), dtype=ref.dtype, device=ref.device)
    for ops, u, v in zip(cones, U, V):
        total = total + ops.obj_value(u, v)
    if lp is not None and ulp is not None:
        total = total + lp.obj_value(ulp, vlp)
    return total
