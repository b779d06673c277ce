"""Conic operators of one SDP cone on the device.

The port of ``ltr_lowrank_sdp_tpu/ops/coneops.py`` for this slice: the
MaxCut family, where every constraint is one diagonal entry and each row
carries exactly one constraint (``diag_identity``; cf. ``detectMaxCutProb``,
``lorads_solver.c:472-497``), with a sparse objective C.  Then

* ``constr_vals`` / ``constr_vals_pair`` are row dots (kernel K2),
* ``cg_normal_matvec`` is a fused row operator (K3),
* ``apply_c`` / ``apply_a`` / ``apply_w`` are one symmetric CSR SpMM with an
  optional diagonal row scale (K1),
* ``obj_value`` is one gathered contraction with a device-side sum (K4).

The constraint space is relabeled so constraint i lives on row i
(``constr_order``), exactly as the JAX package does.  The JAX package also
relabels the *vertex* space for its ELL layout (``spmm_relabel_order``); the
CSR kernel needs no such order, so here factor rows stay in the problem's
own order.  Sparse-A cones, dense cones, non-identity diag cones and the LP
cone are later slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..problem import ConeData, SDPProblem
from . import kernels as K

_LATER = "is a later slice of the port, see ROADMAP.md"


class ConeOps:
    """Device-resident operator bundle for one diag_identity SDP cone."""

    def __init__(self, cone: ConeData, device, dtype=torch.float64):
        if dtype != torch.float64:
            raise NotImplementedError(f"float32 compute {_LATER}")
        if cone.kind_a != "diag":
            raise NotImplementedError(f"a {cone.kind_a!r} constraint cone "
                                      f"{_LATER}")
        if cone.kind_c != "sparse":
            raise NotImplementedError(f"a {cone.kind_c!r} objective {_LATER}")
        n = cone.n
        didx = np.asarray(cone.diag_idx, np.int64)
        dcid = np.asarray(cone.diag_cid, np.int64)
        if not (didx.size == n and cone.m == n
                and np.unique(didx).size == n
                and np.unique(dcid).size == n):
            raise NotImplementedError(
                f"a diag cone whose constraints are not one per row {_LATER}")
        self.n = n
        self.m = cone.m
        self.device = torch.device(device)
        self.dtype = dtype
        self.kind_a = cone.kind_a
        self.kind_c = cone.kind_c
        self.n_active = cone.n_active
        self.rank_max = cone.rank_max
        self.diag_identity = True

        # constraint i == row i: constr_order[i] is the original id of the
        # constraint at internal position i
        by_row = np.argsort(didx)
        self.constr_order = dcid[by_row]
        self.diag_val = torch.tensor(np.asarray(cone.diag_val)[by_row],
                                     dtype=dtype, device=self.device)

        # objective C: full symmetric CSR for K1, upper-triangle COO with
        # off-diagonal entries doubled for K4
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

    # ------------------------------------------------------------------ #

    def constr_vals(self, U, V):
        """A(sym(U V^T)) in the internal constraint order -> (m,)."""
        return K.diag_rowdot(U, V, self.diag_val, 1.0)

    def constr_vals_pair(self, R, D):
        """(A(2 sym(R D^T)), A(D D^T)) in one pass (the ALM line search)."""
        return K.diag_rowdot(R, D, self.diag_val, 2.0, second=True)

    def cg_normal_matvec(self, fixed):
        """The ADMM normal-equation operator
        ``x -> x + A*(A(sym(x fixed^T))) fixed`` (``linSysProduct``,
        ``lorads_admm.c:471-486``)."""
        dv = self.diag_val
        return lambda x: K.diag_normal_matvec(x, fixed, dv)

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
        """A*(w) @ Y: a row scale by diag_val * w."""
        return K.spmm_sym_csr(None, Y, 0.0, d=self.diag_val * w)

    def apply_w(self, w, Y, obj_coef=1.0, include_obj=True):
        """(obj_coef * C + A*(w)) @ Y in one kernel (``mul_rk``)."""
        d = self.diag_val * w
        if not include_obj or self.c_csr is None:
            return K.spmm_sym_csr(None, Y, 0.0, d=d)
        return K.spmm_sym_csr(self.c_csr, Y, float(obj_coef), d=d)

    # flops of one evaluation (the per-dispatch work budgets of the JAX
    # package derive its inner-pass cap from these)
    def constr_flops(self, rank: int) -> int:
        return 2 * self.n_active * rank

    def apply_flops(self, rank: int) -> int:
        return 4 * self.c_nnz * rank + 2 * self.n * rank


def build_cone_ops_internal(prob: SDPProblem, device,
                            dtype=torch.float64
                            ) -> Tuple[List[ConeOps], None, np.ndarray]:
    """Operator bundles for the solver's internal state: ``(cones, lp,
    constr_order)``; the caller permutes ``b`` by ``constr_order`` and
    un-permutes duals at egress."""
    if prob.lp is not None:
        raise NotImplementedError(f"the LP cone {_LATER}")
    if len(prob.cones) != 1:
        raise NotImplementedError(f"multi-block problems {_LATER}")
    cones = [ConeOps(prob.cones[0], device, dtype)]
    return cones, None, cones[0].constr_order
