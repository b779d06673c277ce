"""Conic operators of one SDP cone on the device.

The port of ``ltr_lowrank_sdp_tpu/ops/coneops.py`` for a single-block SDP
with a sparse objective C, in float64.  Two operator paths:

**diag_identity** — the MaxCut family: every constraint is one diagonal
entry and each row carries exactly one constraint (cf. ``detectMaxCutProb``,
``lorads_solver.c:472-497``).  The constraint space is relabeled so
constraint i lives on row i (``constr_order``), exactly as the JAX package
does.  Then

* ``constr_vals`` / ``constr_vals_pair`` are row dots (kernel K2),
* ``cg_normal_matvec`` is a fused row operator (K3),
* ``apply_c`` / ``apply_a`` / ``apply_w`` are one symmetric CSR SpMM with an
  optional diagonal row scale (K1),
* ``obj_value`` is one gathered contraction with a device-side sum (K4).

**general** — sparse constraint matrices (``kind_a == "sparse"``: matrix
completion and the like) and a diag cone that is not one constraint per row
(the same operator with ``rows = cols = diag_idx``).  The constraint space
stays in the problem's order (``constr_order is None``).  Then

* ``constr_vals`` / ``constr_vals_pair`` are the per-entry contraction fused
  with the per-constraint segment sum (K5),
* ``apply_a`` is the constraint-weighted SpMM over the symmetrized pattern
  (K6); ``apply_w`` is K1 (``obj_coef * C @ Y``) then K6 accumulating onto
  it, with no elementwise add between,
* ``cg_normal_matvec`` is K5 on ``(x, fixed)`` then K6 with the result as
  its weights, ``fixed`` as Y and ``x`` as the addend,
* ``apply_c`` and ``obj_value`` are K1 and K4 as above.

The JAX package also relabels the *vertex* space for its ELL layout
(``spmm_relabel_order``); the CSR kernels need no such order, so factor rows
stay in the problem's own order on both paths.  Dense constraint cones, a
dense objective, the LP cone, multi-block problems and float32 compute are
later slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..problem import ConeData, SDPProblem
from . import kernels as K

_LATER = "is a later slice of the port, see ROADMAP.md"


class ConeOps:
    """Device-resident operator bundle for one SDP cone with sparse or diag
    constraints and a sparse objective."""

    def __init__(self, cone: ConeData, device, dtype=torch.float64):
        if dtype != torch.float64:
            raise NotImplementedError(f"float32 compute {_LATER}")
        if cone.kind_a not in ("diag", "sparse"):
            raise NotImplementedError(
                f"a {cone.kind_a!r} constraint cone (the dense-S path: "
                f"materialized C + A*(w) and GEMM) {_LATER}")
        if cone.kind_c != "sparse":
            raise NotImplementedError(
                f"a {cone.kind_c!r} objective (the dense-C GEMM path) "
                f"{_LATER}")
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
        self.a_nnz = 0                      # entries of a sparse-A cone
        if cone.kind_a == "diag":
            didx = np.asarray(cone.diag_idx, np.int64)
            dval = np.asarray(cone.diag_val, np.float64)
            dcid = np.asarray(cone.diag_cid, np.int64)
            if (didx.size == n and cone.m == n and np.unique(didx).size == n
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

        # ---- objective C: full symmetric CSR for K1, upper-triangle COO
        # with off-diagonal entries doubled for K4
        rows = np.asarray(cone.c_rows, np.int64)
        cols = np.asarray(cone.c_cols, np.int64)
        vals = np.asarray(cone.c_vals, np.float64)
        self.c_nnz = int(rows.size)
        self.c_csr = (K.SymCSR.from_upper_coo(rows, cols, vals, n,
                                              self.device, dtype)
                      if self.c_nnz else None)
        self.c_rows = torch.tensor(rows, dtype=torch.int32, device=self.device)
        self.c_cols = torch.tensor(cols, dtype=torch.int32, device=self.device)
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
        return K.sym_contract_sum(self.c_rows, self.c_cols,
                                  self.c_double_coef, U, V)

    def apply_c(self, Y):
        """C @ Y."""
        if self.c_csr is None:
            return torch.zeros_like(Y)
        return K.spmm_sym_csr(self.c_csr, Y, 1.0)

    def apply_a(self, w, Y):
        """A*(w) @ Y: a row scale by diag_val * w under ``diag_identity``,
        else the constraint-weighted SpMM."""
        if self.diag_identity:
            return K.spmm_sym_csr(None, Y, 0.0, d=self.diag_val * w)
        if self.a_csr is None:
            return torch.zeros_like(Y)
        return K.spmm_constr_csr(self.a_csr, w, Y)

    def apply_w(self, w, Y, obj_coef=1.0, include_obj=True):
        """(obj_coef * C + A*(w)) @ Y (``mul_rk``): one kernel under
        ``diag_identity``, else K1 then K6 accumulating onto its output."""
        with_c = include_obj and self.c_csr is not None
        if self.diag_identity:
            d = self.diag_val * w
            if not with_c:
                return K.spmm_sym_csr(None, Y, 0.0, d=d)
            return K.spmm_sym_csr(self.c_csr, Y, float(obj_coef), d=d)
        if not with_c:
            return self.apply_a(w, Y)
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
        return (4 * self.a_nnz * rank + 4 * self.c_nnz * rank
                + 2 * self.n * rank)


def build_cone_ops_internal(prob: SDPProblem, device,
                            dtype=torch.float64
                            ) -> Tuple[List[ConeOps], None,
                                       Optional[np.ndarray]]:
    """Operator bundles for the solver's internal state: ``(cones, lp,
    constr_order)``.  ``constr_order`` is None (constraints in the problem's
    order) or the (m,) map internal -> original constraint id; the caller
    then permutes ``b`` by it and un-permutes duals at egress."""
    if prob.lp is not None:
        raise NotImplementedError(
            f"the LP cone (LPOps.constr_vals, weighted_col_sums) {_LATER}")
    if len(prob.cones) != 1:
        raise NotImplementedError(
            f"multi-block problems ({len(prob.cones)} SDP cones sharing one "
            f"constraint space) {_LATER}")
    cones = [ConeOps(prob.cones[0], device, dtype)]
    return cones, None, cones[0].constr_order
