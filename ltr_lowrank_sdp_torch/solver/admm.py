"""Phase II: ADMM splitting on X = sym(U V^T), as an eager loop.

The port of ``ltr_lowrank_sdp_tpu/solver/admm.py`` (reference
``LORADSADMMOptimize``, ``lorads_admm.c:84-209``, and the variable update
``LORADSUpdateSDPVarOne:564`` / ``LORADSUpdateLPVarOne:759`` /
``linSysProduct:471``): the Gauss-Seidel cone sweep, the under-relaxed Jacobi
sweep (``admm_jacobi``), the closed-form LP sweep, the averaged-iterate
metrics, the divergence/bad-iteration exits and the rho plateau schedule.

* The U update solves (I + A*_V A_V) u = -M2/rho with A_V(x) = A(sym(x V^T))
  by CG (:func:`~..ops.cg.cg_solve`); M1/M2/b_linsys match the reference.
* The per-iteration DIMACS update overwrites the running constraint values
  with those of the averaged factor (U+V)/2, as the reference does.
* ``constr_sum`` is kept by subtracting a cone's old ``constr_val`` and
  adding its new one, never recomputed inside a sweep (the rounding of the
  JAX package).
* LP columns use the closed-form update as one vectorized sweep per side.

The JAX package runs chunks of iterations in one XLA program and reads a
stats blob per chunk; here every iteration reads its metrics (with the
oracle-rank Gram) in one host sync, and every CG iteration reads its
stopping ratio.

float32 compute adds the JAX package's float32-only logic: the penalty
ceiling min(rho_ceiling_admm, 3e5) (CG inner products overflow float32 past
it, ``admm.py:448-453``), the host float64 re-check ``f64_check``
(``admm.py:576-590``, :654-672) and, in main mode, the precision-plateau
exit (``admm.py:613-619``, :674-690) that hands the iterate to the driver's
float64 polish.  The JAX package makes both host decisions only between the
chunks it dispatches (the driver's first main-mode chunk of
``HANDOFF_CHUNK`` iterations, then ``CHUNK`` iterations, or 4 x ``CHUNK``
without the oracle Grams), so :meth:`ADMMPhase.loop` evaluates them after
the same iterations.  (A JAX chunk also ends early at a CG-iteration budget
per dispatch, ``admm.py:126-135``, a bound on one TPU program that the
port has no use for; where it binds, the two boundaries part.)
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
from .common import (Factors, HostSync, ProblemConsts, own_flags,
                     primal_infeas_l1)

CODE_RUN = 0
CODE_CONVERGED = 1
CODE_PINF_OK = 2      # main mode: pinf_inf under tol -> return (gap decides)
CODE_NUM_ERR = 3
CODE_BAD_ITER = 4
CODE_DONE = 5         # overall while-condition turned false
CODE_CEILING = 6

BIG = 1e30

CHUNK = 25           # the JAX ADMMPhase's chunk_size
HANDOFF_CHUNK = 50   # the JAX driver's fused first main-mode chunk
F32_RHO_CEILING = 3e5


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
    ulp: Optional[torch.Tensor] = None         # LP factors, x_lp = ulp o vlp
    vlp: Optional[torch.Tensor] = None
    constr_lp: Optional[torch.Tensor] = None   # LP cone contribution (m,)

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
    plateau: bool = False    # float32 near-feasible plateau (main mode): the
                             # driver's float64 polish signal


class ADMMPhase:
    def __init__(self, cones, b: torch.Tensor, consts: ProblemConsts,
                 params: SolverParams, shapes, sync: HostSync, lp=None,
                 agree=own_flags):
        self.cones = cones
        self.agree = agree      # the stop flags of every rank (driver)
        self.lp = lp
        self.has_lp = lp is not None
        self.b = b
        self.consts = consts
        self.params = params
        self.shapes = tuple(tuple(s) for s in shapes)
        self.sync = sync
        self.f32 = b.dtype == torch.float32
        # float32: CG inner products at rho >~ 1e6 overflow float32 range,
        # so the penalty stops where the normal operator is representable
        self.rho_ceiling = (min(params.rho_ceiling_admm, F32_RHO_CEILING)
                            if self.f32 else params.rho_ceiling_admm)

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
        """One ADMM iteration: cone sweep (Gauss-Seidel, or Jacobi with
        ``admm_jacobi`` on several cones) + LP sweep + metrics."""
        if self.params.admm_jacobi and len(self.cones) > 1:
            return self._iteration_jacobi(carry, rho, cg_tol, want_grams)
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
        if self.has_lp:
            carry = self._lp_sweep(carry, rho)
        carry = self.metrics(carry, CU=tuple(CU), want_grams=want_grams)
        return carry, cg_total

    def _iteration_jacobi(self, carry: ADMMCarry, rho: float, cg_tol: float,
                          want_grams: bool) -> Tuple[ADMMCarry, int]:
        """Jacobi (parallel) cone sweep: every U update solves against the
        entry snapshot of the constraint sum, then every V update against
        the refreshed one, each under-relaxed by the block count,
        U <- U + (U* - U) / K (plain Jacobi diverges when blocks couple
        strongly through shared constraints)."""
        cg_total = 0
        alpha = 1.0 / len(self.cones)

        def csum_of(constr_val):
            return sum(constr_val) + (carry.constr_lp if self.has_lp
                                      else 0.0)

        new_U = []
        for i in range(len(self.cones)):
            u_new, it1 = self._cone_update(i, carry.U[i], carry.V[i],
                                           carry.CV[i], carry, rho, cg_tol)
            new_U.append(carry.U[i] + alpha * (u_new - carry.U[i]))
            cg_total += it1
        constr_val = [ops.constr_vals(u, v) for ops, u, v in
                      zip(self.cones, new_U, carry.V)]
        carry = carry.replace(U=tuple(new_U), constr_val=tuple(constr_val),
                              constr_sum=csum_of(constr_val))

        CU = [ops.apply_c(u) for ops, u in zip(self.cones, carry.U)]
        new_V = []
        for i in range(len(self.cones)):
            v_new, it2 = self._cone_update(i, carry.V[i], carry.U[i], CU[i],
                                           carry, rho, cg_tol)
            new_V.append(carry.V[i] + alpha * (v_new - carry.V[i]))
            cg_total += it2
        constr_val = [ops.constr_vals(u, v) for ops, u, v in
                      zip(self.cones, carry.U, new_V)]
        carry = carry.replace(V=tuple(new_V), constr_val=tuple(constr_val),
                              constr_sum=csum_of(constr_val))

        if self.has_lp:
            carry = self._lp_sweep(carry, rho)
        carry = self.metrics(carry, CU=tuple(CU), want_grams=want_grams)
        return carry, cg_total

    def _lp_sweep(self, carry: ADMMCarry, rho: float) -> ADMMCarry:
        """Closed-form update of every LP column, u side then v side
        (``LORADSUpdateLPVarOne``, ``lorads_admm.c:759-792``)."""
        lp = self.lp

        def one_side(x_upd, x_fix, carry):
            M1g = rho * (carry.constr_sum - self.b) - carry.dual
            x_old = x_upd * x_fix
            base = lp.weighted_col_sums(M1g, obj_coef=carry.obj_scale)
            lpw = base - rho * x_old * lp.nrm2sq
            M2 = lpw * x_fix - rho * x_fix
            return (-M2 / rho) / (1.0 + lp.nrm2sq * x_fix * x_fix)

        ulp = one_side(carry.ulp, carry.vlp, carry)
        new_lp = lp.constr_vals(ulp, carry.vlp)
        carry = carry.replace(
            ulp=ulp, constr_sum=carry.constr_sum - carry.constr_lp + new_lp,
            constr_lp=new_lp)
        vlp = one_side(carry.vlp, carry.ulp, carry)
        new_lp = lp.constr_vals(carry.ulp, vlp)
        return carry.replace(
            vlp=vlp, constr_sum=carry.constr_sum - carry.constr_lp + new_lp,
            constr_lp=new_lp)

    def metrics(self, carry: ADMMCarry, CU=None,
                want_grams: bool = False) -> ADMMCarry:
        """Objective + DIMACS from the averaged factors; the bookkeeping is
        overwritten with the averaged constraint values (reference
        semantics).  <C, Ravg Ravg^T> = 0.25 <U+V, CU + CV>; C·V is carried
        into the next U update.  One host read."""
        Ravg = tuple(0.5 * (u + v) for u, v in zip(carry.U, carry.V))
        rlp_avg = 0.5 * (carry.ulp + carry.vlp) if self.has_lp else None
        CV = tuple(ops.apply_c(v) for ops, v in zip(self.cones, carry.V))
        if CU is None:
            CU = tuple(ops.apply_c(u) for ops, u in zip(self.cones, carry.U))
        obj = torch.zeros((), dtype=self.b.dtype, device=self.b.device)
        cvals = []
        for ops, u, v, cu, cv, r in zip(self.cones, carry.U, carry.V, CU,
                                        CV, Ravg):
            obj = obj + 0.25 * cvdot(u + v, cu + cv)
            cvals.append(ops.constr_vals(r, r))
        constr_lp = carry.constr_lp
        if self.has_lp:
            obj = obj + self.lp.obj_value(rlp_avg, rlp_avg)
            constr_lp = self.lp.constr_vals(rlp_avg, rlp_avg)
        csum = sum(cvals) + (constr_lp if self.has_lp else 0.0)
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
        return carry.replace(CV=CV, constr_val=tuple(cvals),
                             constr_lp=constr_lp, constr_sum=csum,
                             pobj=pobj, dobj=dobj, pinf_l1=pinf,
                             pinf_inf=pinf_inf, gap=gap, grams=gram_h)

    def blank_carry(self, U, V, dual, obj_scale: float, ulp=None,
                    vlp=None) -> ADMMCarry:
        """A carry with zeroed bookkeeping; :meth:`metrics` fills it."""
        return ADMMCarry(
            U=U, V=V, ulp=ulp, vlp=vlp, dual=dual,
            constr_val=tuple(torch.zeros_like(self.b) for _ in self.cones),
            constr_lp=torch.zeros_like(self.b) if self.has_lp else None,
            constr_sum=torch.zeros_like(self.b),
            CV=tuple(torch.zeros_like(v) for v in V),
            obj_scale=float(obj_scale))

    def init_carry(self, U, V, dual, obj_scale: float, ulp=None,
                   vlp=None) -> ADMMCarry:
        return self.metrics(self.blank_carry(U, V, dual, obj_scale, ulp, vlp))

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
        ctrl.rho = min(rho, self.rho_ceiling)
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
             record_cb=None, want_grams: bool = False, f64_check=None,
             chunk_from: Optional[int] = None) -> ADMMCarry:
        """Iterate until a terminal code, the wall-clock limit or SIGINT;
        sets ``ctrl.code`` (CODE_DONE / CODE_CEILING on the natural exits)
        and the ``info`` flags.

        ``f64_check(carry) -> (pobj, dobj, pinf_l1, pinf_inf, gap)`` is the
        driver's float64 host re-evaluation of the averaged iterate.  It and
        the float32 plateau detector run where the JAX package's host sees a
        chunk end: after every ``CHUNK`` (4 ``CHUNK`` without Grams)
        iterations counted from iteration ``chunk_from`` (default: where
        this loop starts)."""
        p = self.params
        if chunk_from is None:
            chunk_from = ctrl.it
        chunk = CHUNK if want_grams else 4 * CHUNK
        checks = f64_check is not None or (self.f32 and mode == "main")
        last_f64_it = -10**9
        f64_every = 0
        plateau_chunks = 0
        plateau_prev_pinf = None
        f64_exit = False
        while (ctrl.code == CODE_RUN and self._overall(carry, ctrl)
               and ctrl.it < iter_ceiling):
            it_before = ctrl.it
            carry, row = self.step(carry, ctrl, mode, want_grams)
            if record_cb is not None:
                record_cb(row, carry.grams or [], it_before)
            if ctrl.code != CODE_RUN:
                break
            if (checks and ctrl.it > chunk_from
                    and (ctrl.it - chunk_from) % chunk == 0
                    and self._overall(carry, ctrl)
                    and ctrl.it < iter_ceiling):
                if (f64_check is not None
                        and carry.pinf_l1 <= p.phase2_tol
                        and carry.gap <= 1e4 * p.phase2_tol
                        and ctrl.it - last_f64_it >= f64_every):
                    # plausibly converged, but the float32 device gap may
                    # not resolve it: re-evaluate the iterate in float64
                    pobj64, dobj64, pinf64, pinfi64, gap64 = f64_check(carry)
                    last_f64_it = ctrl.it
                    if gap64 <= p.phase2_tol and pinf64 <= p.phase2_tol:
                        f64_exit = True
                        break
                    f64_every = CHUNK if gap64 <= 10 * p.phase2_tol \
                        else 4 * CHUNK
                if self.f32 and mode == "main":
                    # precision plateau: near-feasible chunks whose pinf
                    # stopped improving, never certifying
                    near = carry.pinf_l1 <= 1e2 * p.phase2_tol
                    non_improving = (plateau_prev_pinf is not None
                                     and carry.pinf_l1
                                     >= 0.98 * plateau_prev_pinf)
                    plateau_chunks = (plateau_chunks + 1
                                      if near and non_improving else 0)
                    plateau_prev_pinf = carry.pinf_l1
                    if plateau_chunks >= max(2, (6 * 25) // chunk):
                        info.plateau = True
                        break
            time_up, intr = self.agree(
                time.time() - time_start >= p.time_sec_limit,
                interrupt.interrupted())
            if time_up:
                info.time_limit = True
                break
            if intr:
                info.interrupted = True
                break
        if ctrl.code == CODE_RUN and not (info.time_limit or info.interrupted
                                          or info.plateau or f64_exit):
            ctrl.code = (CODE_DONE if not self._overall(carry, ctrl)
                         else CODE_CEILING)
        info.iters = ctrl.it
        info.cg_iters_total = ctrl.cg_total
        if f64_exit:
            # the whole host-mirror metric set in one precision
            info.converged = True
            info.last_pobj, info.last_dobj = pobj64, dobj64
            info.last_pinf, info.last_pinf_inf = pinf64, pinfi64
            info.last_gap = gap64
        else:
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
            entry_pinf: Optional[float] = None, want_grams: bool = False,
            f64_check=None):
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
                          record_cb=record_cb, want_grams=want_grams,
                          f64_check=f64_check)
        code = ctrl.code
        if code in (CODE_CONVERGED, CODE_PINF_OK, CODE_DONE):
            info.converged = (info.last_gap <= p.phase2_tol
                              and info.last_pinf <= p.phase2_tol)
            if code == CODE_CONVERGED and mode != "main":
                info.converged = True
        return carry, ctrl.rho, ctrl.it, info
