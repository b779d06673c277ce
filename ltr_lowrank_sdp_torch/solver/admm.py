"""Phase II: ADMM splitting on X = sym(U V^T), as an eager loop.

The port of ``ltr_lowrank_sdp_tpu/solver/admm.py`` (reference
``LORADSADMMOptimize``, ``lorads_admm.c:84-209``, and the variable update
``LORADSUpdateSDPVarOne:564`` / ``linSysProduct:471``) for this slice: the
Gauss-Seidel cone sweep (``admm.py:176-214``), the averaged-iterate metrics
(``_metrics``), the divergence/bad-iteration exits and the rho plateau
schedule.  The Jacobi sweep and the LP sweep are later slices of the port.

* The U update solves (I + A*_V A_V) u = -M2/rho with A_V(x) = A(sym(x V^T))
  by CG (:func:`~..ops.cg.cg_solve`); M1/M2/b_linsys match the reference.
* The per-iteration DIMACS update overwrites the running constraint values
  with those of the averaged factor (U+V)/2, as the reference does.

The JAX package runs chunks of iterations in one XLA program and reads a
stats blob per chunk; here every iteration reads its metrics (with the
oracle-rank Gram) in one host sync, and every CG iteration reads its
stopping ratio.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SolverParams
from ..ops.cg import cg_solve
from ..ops.compsum import cvdot
from . import interrupt
from .common import Factors, HostSync, ProblemConsts, primal_infeas_l1

CODE_RUN = 0
CODE_CONVERGED = 1
CODE_PINF_OK = 2      # main mode: pinf_inf under tol -> return (gap decides)
CODE_NUM_ERR = 3
CODE_BAD_ITER = 4
CODE_DONE = 5         # overall while-condition turned false
CODE_CEILING = 6

BIG = 1e30


@dataclasses.dataclass
class ADMMCarry:
    U: Factors
    V: Factors
    dual: torch.Tensor
    constr_val: Tuple[torch.Tensor, ...]   # per-cone (m,) bookkeeping
    constr_sum: torch.Tensor
    CV: Factors                            # C @ V_k per cone (current V)
    obj_scale: float
    pobj: float = BIG
    dobj: float = BIG
    pinf_l1: float = BIG
    pinf_inf: float = BIG
    gap: float = BIG
    grams: Optional[List[np.ndarray]] = None   # ((U+V)/2)^T((U+V)/2)

    def replace(self, **kw) -> "ADMMCarry":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ADMMCtrl:
    it: int
    rho: float
    cur_rho_max: float
    old_mean: float = 1e30
    buf: List[float] = dataclasses.field(default_factory=lambda: [0.0] * 10)
    count: int = 0
    bad_pd: int = 0
    cg_total: int = 0
    code: int = CODE_RUN


@dataclasses.dataclass
class ADMMInfo:
    iters: int = 0
    cg_iters_total: int = 0
    num_err: bool = False
    time_limit: bool = False
    interrupted: bool = False
    converged: bool = False
    bad_iter: bool = False
    last_gap: Optional[float] = None
    last_pinf: Optional[float] = None
    last_pinf_inf: Optional[float] = None
    last_pobj: Optional[float] = None
    last_dobj: Optional[float] = None


class ADMMPhase:
    def __init__(self, cones, b: torch.Tensor, consts: ProblemConsts,
                 params: SolverParams, shapes, sync: HostSync):
        self.cones = cones
        self.b = b
        self.consts = consts
        self.params = params
        self.shapes = tuple(tuple(s) for s in shapes)
        self.sync = sync

    # ------------------------------------------------------------------ #

    def _cone_update(self, i, update_var, fixed_var, C_fixed,
                     carry: ADMMCarry, rho: float, cg_tol: float):
        """CG solve for one factor of one cone -> (factor, iters)."""
        ops = self.cones[i]
        M1 = rho * (carry.constr_sum - carry.constr_val[i] - self.b) \
            - carry.dual
        M2 = (ops.apply_a(M1, fixed_var) + carry.obj_scale * C_fixed
              - rho * fixed_var)
        b_lin = -M2 / rho
        res = cg_solve(ops.cg_normal_matvec(fixed_var), b_lin, update_var,
                       cg_tol, self.params.cg_max_iter,
                       self.params.cg_restart_freq, read=self.sync)
        return res.x, res.iters

    def _iteration(self, carry: ADMMCarry, rho: float, cg_tol: float,
                   want_grams: bool) -> Tuple[ADMMCarry, int]:
        """One Gauss-Seidel ADMM iteration: cone sweep + metrics."""
        cg_total = 0
        U = list(carry.U)
        V = list(carry.V)
        constr_val = list(carry.constr_val)
        CU = []
        for i, ops in enumerate(self.cones):
            u_new, it1 = self._cone_update(i, U[i], V[i], carry.CV[i],
                                           carry, rho, cg_tol)
            U[i] = u_new
            new_cv = ops.constr_vals(U[i], V[i])
            carry = carry.replace(
                U=tuple(U),
                constr_sum=carry.constr_sum - constr_val[i] + new_cv)
            constr_val[i] = new_cv
            carry = carry.replace(constr_val=tuple(constr_val))

            C_u = ops.apply_c(U[i])
            v_new, it2 = self._cone_update(i, V[i], U[i], C_u, carry, rho,
                                           cg_tol)
            V[i] = v_new
            new_cv = ops.constr_vals(U[i], V[i])
            carry = carry.replace(
                V=tuple(V),
                constr_sum=carry.constr_sum - constr_val[i] + new_cv)
            constr_val[i] = new_cv
            carry = carry.replace(constr_val=tuple(constr_val))
            cg_total += it1 + it2
            CU.append(C_u)
        carry = self.metrics(carry, CU=tuple(CU), want_grams=want_grams)
        return carry, cg_total

    def metrics(self, carry: ADMMCarry, CU=None,
                want_grams: bool = False) -> ADMMCarry:
        """Objective + DIMACS from the averaged factors; the bookkeeping is
        overwritten with the averaged constraint values (reference
        semantics).  <C, Ravg Ravg^T> = 0.25 <U+V, CU + CV>; C·V is carried
        into the next U update.  One host read."""
        Ravg = tuple(0.5 * (u + v) for u, v in zip(carry.U, carry.V))
        CV = tuple(ops.apply_c(v) for ops, v in zip(self.cones, carry.V))
        if CU is None:
            CU = tuple(ops.apply_c(u) for ops, u in zip(self.cones, carry.U))
        obj = torch.zeros((), dtype=self.b.dtype, device=self.b.device)
        cvals = []
        for ops, u, v, cu, cv, r in zip(self.cones, carry.U, carry.V, CU,
                                        CV, Ravg):
            obj = obj + 0.25 * cvdot(u + v, cu + cv)
            cvals.append(ops.constr_vals(r, r))
        csum = sum(cvals)
        dobj_t = cvdot(self.b, carry.dual) / carry.obj_scale
        pinf_t = primal_infeas_l1(csum, self.b, self.consts.b_nrm1)
        grams = ([torch.matmul(r.T, r) for r in Ravg] if want_grams else [])
        vals = self.sync.flat(obj, dobj_t, pinf_t, *grams)
        pobj, dobj, pinf = vals[:3]
        gram_h = None
        if want_grams:
            gram_h, off = [], 3
            for (_, r) in self.shapes:
                gram_h.append(np.asarray(vals[off: off + r * r]).reshape(r, r))
                off += r * r
        pinf_inf = pinf * (1.0 + self.consts.b_nrm1) / (
            1.0 + self.consts.b_nrminf)
        gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        return carry.replace(CV=CV, constr_val=tuple(cvals), constr_sum=csum,
                             pobj=pobj, dobj=dobj, pinf_l1=pinf,
                             pinf_inf=pinf_inf, gap=gap, grams=gram_h)

    def init_carry(self, U, V, dual, obj_scale: float) -> ADMMCarry:
        carry = ADMMCarry(
            U=U, V=V, dual=dual,
            constr_val=tuple(torch.zeros_like(self.b) for _ in self.cones),
            constr_sum=torch.zeros_like(self.b),
            CV=tuple(torch.zeros_like(v) for v in V),
            obj_scale=float(obj_scale))
        return self.metrics(carry)

    def make_ctrl(self, rho: float, rho_max: float,
                  iter_start: int = 0) -> ADMMCtrl:
        return ADMMCtrl(it=iter_start, rho=float(rho),
                        cur_rho_max=float(rho_max))

    # ------------------------------------------------------------------ #

    def _advance(self, carry: ADMMCarry, ctrl: ADMMCtrl, mode: str
                 ) -> ADMMCarry:
        """Dual update + rho schedule with plateau-triggered rhoMax
        escalation every rho_freq*100 iterations."""
        p = self.params
        carry = carry.replace(
            dual=carry.dual + ctrl.rho * (self.b - carry.constr_sum))
        it1 = ctrl.it + 1
        tick_it = it1 if mode == "main" else ctrl.it
        do_rho = tick_it % p.rho_freq == 0
        rho = ctrl.rho * p.rho_factor if do_rho else ctrl.rho
        hit_max = do_rho and rho >= ctrl.cur_rho_max
        if hit_max:
            rho = ctrl.cur_rho_max
        plateau_tick = hit_max and tick_it % (p.rho_freq * 100) == 0
        mean = sum(abs(x) for x in ctrl.buf) / 10.0
        stalled = plateau_tick and mean / ctrl.old_mean >= 0.65
        if stalled:
            bump = p.rho_factor ** round(
                np.log(p.rho_freq * 100) / np.log(p.rho_freq))
            rho = rho * bump
            ctrl.cur_rho_max = rho
        if plateau_tick:
            ctrl.old_mean = mean
        ctrl.it = it1
        ctrl.rho = min(rho, p.rho_ceiling_admm)
        return carry

    def step(self, carry: ADMMCarry, ctrl: ADMMCtrl, mode: str,
             want_grams: bool) -> Tuple[ADMMCarry, List[float]]:
        """One iteration with its exit logic (the JAX chunk body); updates
        ``ctrl`` and returns (carry, stats row)."""
        p = self.params
        cg_tol = min(carry.pinf_l1 * (1e-2 if mode == "main" else 1e-4),
                     1e-8)
        carry, cg_iters = self._iteration(carry, ctrl.rho, cg_tol,
                                          want_grams)
        ctrl.cg_total += cg_iters
        row = [carry.pobj, carry.dobj, carry.pinf_l1, carry.pinf_inf,
               carry.gap, ctrl.rho, float(cg_iters)]

        # divergence guard + explicit NaN check
        num_err = (carry.pinf_inf >= 1e10 or carry.gap >= 1 - 1e-8
                   or math.isnan(carry.pinf_l1) or math.isnan(carry.gap)
                   or math.isnan(carry.pobj))
        # bad-iteration counters (lorads_admm.c:147-170)
        bad = ctrl.bad_pd
        if carry.gap <= p.phase2_tol * 5:
            bad = max(0, bad - 5)
        if carry.gap >= p.phase1_tol * 1e2:
            bad = bad + 2
        bad_exit = bad >= (800 if mode == "main" else 200)
        ctrl.buf[ctrl.count % 10] = carry.pinf_inf
        ctrl.count += 1
        ctrl.bad_pd = bad

        pinf_exit = mode == "main" and carry.pinf_inf <= p.phase2_tol
        conv_exit = (carry.pinf_l1 <= p.phase2_tol
                     and carry.gap <= p.phase2_tol)
        early = (carry.gap <= p.phase2_tol * 1e-3
                 and carry.pinf_l1 <= p.phase2_tol * 1e-3)
        code = (CODE_NUM_ERR if num_err else CODE_BAD_ITER if bad_exit
                else CODE_PINF_OK if pinf_exit
                else CODE_CONVERGED if (conv_exit or early) else CODE_RUN)
        if code == CODE_RUN:
            carry = self._advance(carry, ctrl, mode)
        ctrl.code = code
        return carry, row

    def _overall(self, carry: ADMMCarry, ctrl: ADMMCtrl) -> bool:
        p = self.params
        return (ctrl.it <= p.max_admm_iter or carry.gap >= p.phase2_tol
                or carry.pinf_l1 >= p.phase2_tol)

    def loop(self, carry: ADMMCarry, ctrl: ADMMCtrl, *, mode: str,
             iter_ceiling: int, time_start: float, info: ADMMInfo,
             record_cb=None, want_grams: bool = False) -> ADMMCarry:
        """Iterate until a terminal code, the wall-clock limit or SIGINT;
        sets ``ctrl.code`` (CODE_DONE / CODE_CEILING on the natural exits)
        and the ``info`` flags."""
        p = self.params
        while (ctrl.code == CODE_RUN and self._overall(carry, ctrl)
               and ctrl.it < iter_ceiling):
            it_before = ctrl.it
            carry, row = self.step(carry, ctrl, mode, want_grams)
            if record_cb is not None:
                record_cb(row, carry.grams or [], it_before)
            if ctrl.code != CODE_RUN:
                break
            if time.time() - time_start >= p.time_sec_limit:
                info.time_limit = True
                break
            if interrupt.interrupted():
                info.interrupted = True
                break
        if ctrl.code == CODE_RUN and not (info.time_limit
                                          or info.interrupted):
            ctrl.code = (CODE_DONE if not self._overall(carry, ctrl)
                         else CODE_CEILING)
        info.iters = ctrl.it
        info.cg_iters_total = ctrl.cg_total
        info.last_gap, info.last_pinf = carry.gap, carry.pinf_l1
        info.last_pinf_inf = carry.pinf_inf
        info.last_pobj, info.last_dobj = carry.pobj, carry.dobj
        info.num_err = ctrl.code == CODE_NUM_ERR
        info.bad_iter = ctrl.code == CODE_BAD_ITER
        return carry

    def run(self, carry: ADMMCarry, rho: float, iter_start: int,
            iter_ceiling: int, time_start: float, mode: str = "main",
            record_cb=None, rho_max: Optional[float] = None,
            entry_gap: Optional[float] = None,
            entry_pinf: Optional[float] = None, want_grams: bool = False):
        """The reopt-round entry (``ADMMPhase.run``): returns
        (carry, last rho, iteration counter, info)."""
        p = self.params
        if rho_max is None:
            rho_max = p.rho_max
        info = ADMMInfo()
        if entry_gap is None:
            entry_gap = carry.gap
        if entry_pinf is None:
            entry_pinf = carry.pinf_l1
        if entry_gap <= p.phase2_tol and entry_pinf <= p.phase2_tol:
            info.converged = True
            info.last_gap, info.last_pinf = entry_gap, entry_pinf
            return carry, rho, iter_start, info
        ctrl = self.make_ctrl(min(rho, rho_max), rho_max, iter_start)
        carry = self.loop(carry, ctrl, mode=mode, iter_ceiling=iter_ceiling,
                          time_start=time_start, info=info,
                          record_cb=record_cb, want_grams=want_grams)
        code = ctrl.code
        if code in (CODE_CONVERGED, CODE_PINF_OK, CODE_DONE):
            info.converged = (info.last_gap <= p.phase2_tol
                              and info.last_pinf <= p.phase2_tol)
            if code == CODE_CONVERGED and mode != "main":
                info.converged = True
        return carry, ctrl.rho, ctrl.it, info
