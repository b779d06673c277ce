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
stats blob per chunk (``_chunk_step``, ``parse_blob``).  So does
:meth:`ADMMPhase.loop`: a chunk of iterations with their CG solves is one
body of device tensors (:meth:`ADMMPhase._dev_chunk`: a WHILE over the
iterations, a WHILE per CG solve, IF nodes for the CG restart, the dual
update and the rho plateau), captured once per (mode, Grams, objective
scale) as a CUDA graph and replayed, with one host read of the chunk's
stats rows, Grams and control state; on the CPU the same body runs under
the host flow (``solver/devloop.py``) and gives the eager loop's bits.
:meth:`ADMMPhase.loop_eager` keeps the eager loop, one read per iteration's
metrics and per CG iteration, for the sharded mode (whose all-reduces run
through the host) and as the tests' reference.  Both check the time limit
and SIGINT where the JAX host sees a chunk end.

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
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SolverParams
from ..ops.cg import cg_device, cg_solve
from ..ops.compsum import cvdot
from ..ops.scalars import hdiv, sdiv, smul
from . import interrupt
from .common import (Factors, HostSync, ProblemConsts, own_flags,
                     primal_infeas_l1)
from .devloop import DeviceGraph, HostFlow

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
ROWS = 4 * CHUNK     # stats rows a device chunk holds (its longest chunk)
N_STATS = 7          # pobj dobj pinf_l1 pinf_inf gap rho cg_iters (STAT_COLS)


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
                 agree=own_flags, device_loop: bool = True, red=None):
        self.cones = cones
        # the row-sharded mode's reduction point (parallel/rowshard.py)
        self.red = red
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
        # the device-resident loop (else the eager one: the sharded modes)
        self.device_loop = device_loop
        self._graphs = {}

    # ------------------------------------------------------------------ #

    def _cone_update(self, i, update_var, fixed_var, C_fixed,
                     carry: ADMMCarry, rho, solve):
        """The CG system for one factor of one cone, solved by ``solve(
        matvec, b_lin, x0)`` -> (factor, iters).  ``rho``: a host float or
        a 0-dim device tensor."""
        ops = self.cones[i]
        M1 = smul(rho, carry.constr_sum - carry.constr_val[i] - self.b) \
            - carry.dual
        M2 = (ops.apply_a(M1, fixed_var) + carry.obj_scale * C_fixed
              - smul(rho, fixed_var))
        b_lin = sdiv(-M2, rho)
        return solve(ops.cg_normal_matvec(fixed_var), b_lin, update_var)

    def _eager_solve(self, cg_tol: float):
        def solve(mv, b_lin, x0):
            res = cg_solve(mv, b_lin, x0, cg_tol, self.params.cg_max_iter,
                           self.params.cg_restart_freq, read=self.sync,
                           red=self.red)
            return res.x, res.iters
        return solve

    def _iteration(self, carry: ADMMCarry, rho: float, cg_tol: float,
                   want_grams: bool) -> Tuple[ADMMCarry, int]:
        """One eager ADMM iteration: the sweep + the metrics (one read)."""
        carry, cg_total, CU = self._sweep(carry, rho,
                                          self._eager_solve(cg_tol))
        return self.metrics(carry, CU=CU, want_grams=want_grams), cg_total

    def _sweep(self, carry: ADMMCarry, rho, solve):
        """The cone sweep (Gauss-Seidel, or Jacobi with ``admm_jacobi`` on
        several cones) + the LP sweep: (carry, CG iterations, C·U)."""
        if self.params.admm_jacobi and len(self.cones) > 1:
            carry, cg_total, CU = self._sweep_jacobi(carry, rho, solve)
        else:
            cg_total = 0
            U = list(carry.U)
            V = list(carry.V)
            constr_val = list(carry.constr_val)
            CU = []
            for i, ops in enumerate(self.cones):
                u_new, it1 = self._cone_update(i, U[i], V[i], carry.CV[i],
                                               carry, rho, solve)
                U[i] = u_new
                new_cv = ops.constr_vals(U[i], V[i])
                carry = carry.replace(
                    U=tuple(U),
                    constr_sum=carry.constr_sum - constr_val[i] + new_cv)
                constr_val[i] = new_cv
                carry = carry.replace(constr_val=tuple(constr_val))

                C_u = ops.apply_c(U[i])
                v_new, it2 = self._cone_update(i, V[i], U[i], C_u, carry,
                                               rho, solve)
                V[i] = v_new
                new_cv = ops.constr_vals(U[i], V[i])
                carry = carry.replace(
                    V=tuple(V),
                    constr_sum=carry.constr_sum - constr_val[i] + new_cv)
                constr_val[i] = new_cv
                carry = carry.replace(constr_val=tuple(constr_val))
                cg_total = cg_total + it1 + it2
                CU.append(C_u)
            CU = tuple(CU)
        if self.has_lp:
            carry = self._lp_sweep(carry, rho)
        return carry, cg_total, CU

    def _sweep_jacobi(self, carry: ADMMCarry, rho, solve):
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
                                           carry.CV[i], carry, rho, solve)
            new_U.append(carry.U[i] + alpha * (u_new - carry.U[i]))
            cg_total = cg_total + it1
        constr_val = [ops.constr_vals(u, v) for ops, u, v in
                      zip(self.cones, new_U, carry.V)]
        carry = carry.replace(U=tuple(new_U), constr_val=tuple(constr_val),
                              constr_sum=csum_of(constr_val))

        CU = [ops.apply_c(u) for ops, u in zip(self.cones, carry.U)]
        new_V = []
        for i in range(len(self.cones)):
            v_new, it2 = self._cone_update(i, carry.V[i], carry.U[i], CU[i],
                                           carry, rho, solve)
            new_V.append(carry.V[i] + alpha * (v_new - carry.V[i]))
            cg_total = cg_total + it2
        constr_val = [ops.constr_vals(u, v) for ops, u, v in
                      zip(self.cones, carry.U, new_V)]
        carry = carry.replace(V=tuple(new_V), constr_val=tuple(constr_val),
                              constr_sum=csum_of(constr_val))
        return carry, cg_total, tuple(CU)

    def _lp_sweep(self, carry: ADMMCarry, rho) -> ADMMCarry:
        """Closed-form update of every LP column, u side then v side
        (``LORADSUpdateLPVarOne``, ``lorads_admm.c:759-792``)."""
        lp = self.lp

        def one_side(x_upd, x_fix, carry):
            M1g = smul(rho, carry.constr_sum - self.b) - carry.dual
            x_old = x_upd * x_fix
            base = lp.weighted_col_sums(M1g, obj_coef=carry.obj_scale)
            lpw = base - smul(rho, x_old) * lp.nrm2sq
            M2 = lpw * x_fix - smul(rho, x_fix)
            return sdiv(-M2, rho) / (1.0 + lp.nrm2sq * x_fix * x_fix)

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

    def _metric_tensors(self, carry: ADMMCarry, CU=None,
                        want_grams: bool = False):
        """Objective + DIMACS from the averaged factors, on the device; the
        bookkeeping is overwritten with the averaged constraint values
        (reference semantics).  <C, Ravg Ravg^T> = 0.25 <U+V, CU + CV>; C·V
        is carried into the next U update.  Returns (carry, <C, X>, dobj,
        pinf_l1, Grams) in the compute dtype."""
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
        grams = ([torch.matmul(r.T, r) for r in Ravg] if want_grams else [])
        if self.red is None:
            dobj_t = cvdot(self.b, carry.dual) / carry.obj_scale
            pinf_t = primal_infeas_l1(csum, self.b, self.consts.b_nrm1)
        else:
            obj, bd, rn, grams = self.red.metric_terms(
                obj, self.b, carry.dual, csum, grams)
            dobj_t = bd / carry.obj_scale
            pinf_t = rn / (1.0 + self.consts.b_nrm1)
        carry = carry.replace(CV=CV, constr_val=tuple(cvals),
                              constr_lp=constr_lp, constr_sum=csum)
        return carry, obj, dobj_t, pinf_t, grams

    def metrics(self, carry: ADMMCarry, CU=None,
                want_grams: bool = False) -> ADMMCarry:
        """:meth:`_metric_tensors` and one host read of its scalars (and
        the oracle-rank Grams)."""
        carry, obj, dobj_t, pinf_t, grams = self._metric_tensors(
            carry, CU, want_grams)
        vals = self.sync.flat(obj, dobj_t, pinf_t, *grams)
        pobj, dobj, pinf = vals[:3]
        gram_h = None
        if want_grams:
            gram_h = self._grams_of(vals[3:])
        pinf_inf = pinf * (1.0 + self.consts.b_nrm1) / (
            1.0 + self.consts.b_nrminf)
        gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        return carry.replace(pobj=pobj, dobj=dobj, pinf_l1=pinf,
                             pinf_inf=pinf_inf, gap=gap, grams=gram_h)

    def _grams_of(self, flat) -> List[np.ndarray]:
        out, off = [], 0
        for (_, r) in self.shapes:
            out.append(np.asarray(flat[off: off + r * r],
                                  np.float64).reshape(r, r))
            off += r * r
        return out

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
    # the eager loop

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
            rho = rho * self._bump()
            ctrl.cur_rho_max = rho
        if plateau_tick:
            ctrl.old_mean = mean
        ctrl.it = it1
        ctrl.rho = min(rho, self.rho_ceiling)
        return carry

    def _bump(self) -> float:
        p = self.params
        return p.rho_factor ** round(
            np.log(p.rho_freq * 100) / np.log(p.rho_freq))

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

    @staticmethod
    def _boundary(it: int, chunk_from: int, chunk: int) -> int:
        """The first chunk end after iteration ``it``: ``chunk_from``, then
        every ``chunk`` iterations (where the JAX host sees the loop)."""
        if it < chunk_from:
            return chunk_from
        return chunk_from + chunk * ((it - chunk_from) // chunk + 1)

    def loop(self, carry: ADMMCarry, ctrl: ADMMCtrl, **kw) -> ADMMCarry:
        """Iterate until a terminal code, the wall-clock limit or SIGINT:
        the device-resident loop (:meth:`loop_device`), or with
        ``device_loop`` off the eager one (:meth:`loop_eager`)."""
        if self.device_loop:
            return self.loop_device(carry, ctrl, **kw)
        return self.loop_eager(carry, ctrl, **kw)

    def loop_eager(self, carry: ADMMCarry, ctrl: ADMMCtrl, *, mode: str,
                   iter_ceiling: int, time_start: float, info: ADMMInfo,
                   record_cb=None, want_grams: bool = False, f64_check=None,
                   chunk_from: Optional[int] = None) -> ADMMCarry:
        """Iterate until a terminal code, the wall-clock limit or SIGINT;
        sets ``ctrl.code`` (CODE_DONE / CODE_CEILING on the natural exits)
        and the ``info`` flags.

        ``f64_check(carry) -> (pobj, dobj, pinf_l1, pinf_inf, gap)`` is the
        Solver's float64 host re-evaluation of the averaged iterate.  It,
        the float32 plateau detector, the time limit and SIGINT run where
        the JAX package's host sees a chunk end: after iteration
        ``chunk_from`` (default: where this loop starts) and every ``CHUNK``
        (4 ``CHUNK`` without Grams) iterations after it."""
        if chunk_from is None:
            chunk_from = ctrl.it
        chunk = CHUNK if want_grams else 4 * CHUNK
        ends = _ChunkEnds(self, mode, iter_ceiling, time_start, info,
                          f64_check, chunk_from, chunk)
        while (ctrl.code == CODE_RUN and self._overall(carry, ctrl)
               and ctrl.it < iter_ceiling):
            it_before = ctrl.it
            carry, row = self.step(carry, ctrl, mode, want_grams)
            if record_cb is not None:
                record_cb(row, carry.grams or [], it_before)
            if ctrl.code != CODE_RUN:
                break
            if (ctrl.it == self._boundary(it_before, chunk_from, chunk)
                    and ends.stop(carry, ctrl)):
                break
        return ends.finish(carry, ctrl)

    # ------------------------------------------------------------------ #
    # the device-resident loop

    def _new_state(self, want_grams: bool) -> SimpleNamespace:
        """The device loop's state tensors (values unset): the carry's
        tensors, its float64 scalars, the control state and the chunk's
        stats rows and Grams."""
        dev, dt = self.b.device, self.b.dtype

        def like(t):
            return None if t is None else torch.empty_like(t)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=dev)

        return SimpleNamespace(
            U=[torch.empty(s, dtype=dt, device=dev) for s in self.shapes],
            V=[torch.empty(s, dtype=dt, device=dev) for s in self.shapes],
            ulp=like(self.lp.nrm2sq) if self.has_lp else None,
            vlp=like(self.lp.nrm2sq) if self.has_lp else None,
            dual=like(self.b),
            constr_val=[like(self.b) for _ in self.cones],
            constr_lp=like(self.b) if self.has_lp else None,
            constr_sum=like(self.b),
            CV=[torch.empty(s, dtype=dt, device=dev) for s in self.shapes],
            **{k: scalar(torch.float64) for k in _F64_STATE},
            **{k: scalar(torch.int64) for k in _INT_STATE},
            buf=torch.zeros(10, dtype=torch.float64, device=dev),
            chunk_end=scalar(torch.int64), ceiling=scalar(torch.int64),
            rows=scalar(torch.int64),
            stats=torch.zeros((ROWS, N_STATS), dtype=torch.float64,
                              device=dev),
            grams=torch.zeros((ROWS, sum(r * r for _, r in self.shapes)
                               if want_grams else 0), dtype=dt, device=dev))

    @staticmethod
    def _fill_state(S: SimpleNamespace, carry: ADMMCarry,
                    ctrl: ADMMCtrl) -> SimpleNamespace:
        """``carry`` and ``ctrl`` copied into ``S`` (no host read)."""
        for k in ("U", "V", "constr_val", "CV"):
            for d, x in zip(getattr(S, k), getattr(carry, k)):
                d.copy_(x)
        for k in ("ulp", "vlp", "dual", "constr_lp", "constr_sum"):
            if getattr(S, k) is not None:
                getattr(S, k).copy_(getattr(carry, k))
        for k in _F64_STATE:
            src = ctrl if k in ("rho", "cur_rho_max", "old_mean") else carry
            getattr(S, k).fill_(float(getattr(src, k)))
        for k in _INT_STATE:
            getattr(S, k).fill_(int(getattr(ctrl, k)))
        S.buf.copy_(torch.tensor(ctrl.buf, dtype=torch.float64),
                    non_blocking=True)
        return S

    @staticmethod
    def _clone_state(S: SimpleNamespace) -> SimpleNamespace:
        return SimpleNamespace(**{
            k: ([x.clone() for x in v] if isinstance(v, list)
                else v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in vars(S).items()})

    def _carry_of(self, S: SimpleNamespace, obj_scale: float,
                  clone: bool) -> ADMMCarry:
        def c(t):
            return None if t is None else (t.clone() if clone else t)
        return ADMMCarry(
            U=tuple(c(u) for u in S.U), V=tuple(c(v) for v in S.V),
            dual=c(S.dual), constr_val=tuple(c(x) for x in S.constr_val),
            constr_sum=c(S.constr_sum), CV=tuple(c(x) for x in S.CV),
            obj_scale=obj_scale, ulp=c(S.ulp), vlp=c(S.vlp),
            constr_lp=c(S.constr_lp))

    def _overall_t(self, S) -> torch.Tensor:
        p = self.params
        return ((S.it <= p.max_admm_iter) | (S.gap >= p.phase2_tol)
                | (S.pinf_l1 >= p.phase2_tol))

    def _dev_chunk(self, flow, S, mode: str, want_grams: bool,
                   obj_scale: float) -> None:
        """One chunk on the device: iterations while the code is RUN, the
        overall condition holds and the iteration count is under the
        ceiling and the chunk's end (``S.chunk_end``); each writes its
        stats row (and Grams) at ``S.rows``."""
        def live():
            return ((S.code == CODE_RUN) & self._overall_t(S)
                    & (S.it < S.ceiling) & (S.it < S.chunk_end))

        flow.while_(live, lambda: self._dev_step(flow, S, mode, want_grams,
                                                 obj_scale))

    def _dev_step(self, flow, S, mode: str, want_grams: bool,
                  obj_scale: float) -> None:
        """:meth:`step` as a body of device tensors (no host read)."""
        p = self.params
        main = mode == "main"
        cg_tol = torch.minimum(S.pinf_l1 * (1e-2 if main else 1e-4),
                               torch.full_like(S.pinf_l1, 1e-8))

        def solve(mv, b_lin, x0):
            return cg_device(flow, mv, b_lin, x0, cg_tol,
                             p.cg_max_iter, p.cg_restart_freq)

        carry = self._carry_of(S, obj_scale, clone=False)
        new, cg_iters, CU = self._sweep(carry, S.rho, solve)
        new, obj, dobj_t, pinf_t, grams = self._metric_tensors(
            new, CU, want_grams)
        for k in ("U", "V", "constr_val", "CV"):
            for d, x in zip(getattr(S, k), getattr(new, k)):
                d.copy_(x)
        for k in ("ulp", "vlp", "constr_lp", "constr_sum"):
            if getattr(S, k) is not None:
                getattr(S, k).copy_(getattr(new, k))
        # the scalars the eager loop reads, in float64 as read
        pobj, dobj, pinf = obj.double(), dobj_t.double(), pinf_t.double()
        pinf_inf = hdiv(pinf * (1.0 + self.consts.b_nrm1),
                        1.0 + self.consts.b_nrminf)
        gap = (torch.abs(pobj - dobj)
               / (1.0 + torch.abs(pobj) + torch.abs(dobj)))
        for d, x in ((S.pobj, pobj), (S.dobj, dobj), (S.pinf_l1, pinf),
                     (S.pinf_inf, pinf_inf), (S.gap, gap)):
            d.copy_(x)
        at = S.rows.reshape(1)
        # (a problem without SDP cones runs no CG: the count is the int 0)
        cg_iters = cg_iters + torch.zeros_like(S.cg_total)
        S.cg_total.add_(cg_iters)
        S.stats.index_copy_(0, at, torch.stack(
            [pobj, dobj, pinf, pinf_inf, gap, S.rho,
             cg_iters.double()]).reshape(1, N_STATS))
        if want_grams:
            S.grams.index_copy_(0, at, torch.cat(
                [g.reshape(-1) for g in grams]).reshape(1, -1))
        S.rows.add_(1)

        # divergence guard + explicit NaN check
        num_err = ((pinf_inf >= 1e10) | (gap >= 1 - 1e-8) | torch.isnan(pinf)
                   | torch.isnan(gap) | torch.isnan(pobj))
        # bad-iteration counters (lorads_admm.c:147-170)
        bad = S.bad_pd
        bad = torch.where(gap <= p.phase2_tol * 5,
                          torch.clamp(bad - 5, min=0), bad)
        bad = torch.where(gap >= p.phase1_tol * 1e2, bad + 2, bad)
        bad_exit = bad >= (800 if main else 200)
        S.buf.index_copy_(0, torch.remainder(S.count, 10).reshape(1),
                          pinf_inf.reshape(1))
        S.count.add_(1)
        S.bad_pd.copy_(bad)
        conv = (pinf <= p.phase2_tol) & (gap <= p.phase2_tol)
        early = (gap <= p.phase2_tol * 1e-3) & (pinf <= p.phase2_tol * 1e-3)
        code = torch.where(conv | early, CODE_CONVERGED, CODE_RUN)
        if main:
            code = torch.where(pinf_inf <= p.phase2_tol, CODE_PINF_OK, code)
        code = torch.where(bad_exit, CODE_BAD_ITER, code)
        code = torch.where(num_err, CODE_NUM_ERR, code)
        S.code.copy_(code)
        flow.if_(S.code == CODE_RUN, lambda: self._dev_advance(flow, S, main))

    def _dev_advance(self, flow, S, main: bool) -> None:
        """:meth:`_advance` on the device."""
        p = self.params
        S.dual.copy_(S.dual + smul(S.rho, self.b - S.constr_sum))
        it1 = S.it + 1
        tick = it1 if main else S.it.clone()
        do_rho = torch.remainder(tick, p.rho_freq) == 0
        rho = torch.where(do_rho, S.rho * p.rho_factor, S.rho)
        hit_max = do_rho & (rho >= S.cur_rho_max)
        S.rho.copy_(torch.where(hit_max, S.cur_rho_max, rho))
        plateau_tick = hit_max & (
            torch.remainder(tick, p.rho_freq * 100) == 0)

        def plateau():
            a = torch.abs(S.buf)
            total = a[0]
            for j in range(1, a.shape[0]):
                total = total + a[j]
            mean = hdiv(total, 10.0)
            stalled = mean / S.old_mean >= 0.65
            S.rho.copy_(torch.where(stalled, S.rho * self._bump(), S.rho))
            S.cur_rho_max.copy_(torch.where(stalled, S.rho, S.cur_rho_max))
            S.old_mean.copy_(mean)

        flow.if_(plateau_tick, plateau)
        S.it.copy_(it1)
        S.rho.copy_(torch.minimum(S.rho,
                                  torch.full_like(S.rho, self.rho_ceiling)))

    def _graph(self, carry: ADMMCarry, ctrl: ADMMCtrl, mode: str,
               want_grams: bool):
        """The chunk's graph for (mode, Grams, objective scale) and its
        static state, captured at first use (warmed up on a copy of a state
        holding ``carry`` and ``ctrl``)."""
        obj_scale = carry.obj_scale
        key = (mode, want_grams, obj_scale)
        if key not in self._graphs:
            S = self._fill_state(self._new_state(want_grams), carry, ctrl)
            S.ceiling.fill_(ctrl.it + 1)
            S.chunk_end.fill_(ctrl.it + 1)
            g = DeviceGraph(
                f"admm-{mode}" + ("-grams" if want_grams else ""),
                self.b.device,
                lambda flow, st: self._dev_chunk(flow, st, mode, want_grams,
                                                 obj_scale),
                S, lambda: self._clone_state(S))
            self.sync.graphs.append(g.describe())
            self._graphs[key] = (g, S)
        return self._graphs[key]

    def loop_device(self, carry: ADMMCarry, ctrl: ADMMCtrl, *, mode: str,
                    iter_ceiling: int, time_start: float, info: ADMMInfo,
                    record_cb=None, want_grams: bool = False, f64_check=None,
                    chunk_from: Optional[int] = None) -> ADMMCarry:
        """:meth:`loop_eager`'s decisions, made on the device: each chunk
        (to the next chunk end) is one replay of the chunk's CUDA graph
        (on the CPU one run of its body under the host flow) and one host
        read of its stats rows, Grams and control state; the host then
        records the rows and takes the chunk-end decisions."""
        if chunk_from is None:
            chunk_from = ctrl.it
        chunk = CHUNK if want_grams else 4 * CHUNK
        ends = _ChunkEnds(self, mode, iter_ceiling, time_start, info,
                          f64_check, chunk_from, chunk)
        cuda = self.b.is_cuda
        graph = None
        if cuda:
            graph, S = self._graph(carry, ctrl, mode, want_grams)
        else:
            S = self._new_state(want_grams)
        self._fill_state(S, carry, ctrl)
        S.ceiling.fill_(int(iter_ceiling))
        last_grams = carry.grams
        while True:
            it0 = ctrl.it
            end = self._boundary(it0, chunk_from, chunk)
            n_rows = max(0, min(end, iter_ceiling) - it0)
            if n_rows > ROWS:
                raise ValueError(f"a chunk of {n_rows} rows: at most {ROWS}")
            S.chunk_end.fill_(end)
            S.rows.zero_()
            if graph is not None:
                graph.launch()
                self.sync.replays += 1
            else:
                self._dev_chunk(HostFlow, S, mode, want_grams,
                                carry.obj_scale)
            head = torch.stack([
                S.rows.double(), S.code.double(), S.it.double(),
                S.count.double(), S.bad_pd.double(), S.cg_total.double(),
                S.pobj, S.dobj, S.pinf_l1, S.pinf_inf, S.gap, S.rho,
                S.cur_rho_max, S.old_mean])
            parts = [head, S.buf, S.stats[:n_rows].reshape(-1),
                     S.grams[:n_rows].reshape(-1).double()]
            if graph is not None:
                parts.append(graph.runs[:len(graph.bodies)].double())
            vals = np.asarray(self.sync.flat(*parts))
            (rows, code, it, count, bad_pd, cg_total, pobj, dobj, pinf,
             pinf_inf, gap, rho, cur_rho_max, old_mean) = vals[:14]
            off = 14
            ctrl.buf = [float(x) for x in vals[off: off + 10]]
            off += 10
            stats = vals[off: off + n_rows * N_STATS].reshape(n_rows,
                                                               N_STATS)
            off += n_rows * N_STATS
            gsize = S.grams.shape[1]
            gram_rows = vals[off: off + n_rows * gsize].reshape(n_rows,
                                                                gsize)
            off += n_rows * gsize
            if graph is not None:
                graph.account(vals[off:])
            for j in range(int(rows)):
                grams_j = self._grams_of(gram_rows[j]) if want_grams else []
                if want_grams:
                    last_grams = grams_j
                if record_cb is not None:
                    record_cb([float(x) for x in stats[j]], grams_j,
                              it0 + j)
            ctrl.code, ctrl.it = int(code), int(it)
            ctrl.count, ctrl.bad_pd = int(count), int(bad_pd)
            ctrl.cg_total = int(cg_total)
            ctrl.rho, ctrl.cur_rho_max = float(rho), float(cur_rho_max)
            ctrl.old_mean = float(old_mean)
            carry = carry.replace(pobj=float(pobj), dobj=float(dobj),
                                  pinf_l1=float(pinf),
                                  pinf_inf=float(pinf_inf), gap=float(gap),
                                  grams=last_grams)
            if ctrl.code != CODE_RUN:
                break
            if ctrl.it == end and ends.stop(
                    self._carry_of(S, carry.obj_scale, clone=False).replace(
                        pobj=carry.pobj, dobj=carry.dobj,
                        pinf_l1=carry.pinf_l1, pinf_inf=carry.pinf_inf,
                        gap=carry.gap), ctrl):
                break
            if not (self._overall(carry, ctrl) and ctrl.it < iter_ceiling):
                break
        out = self._carry_of(S, carry.obj_scale, clone=cuda).replace(
            pobj=carry.pobj, dobj=carry.dobj, pinf_l1=carry.pinf_l1,
            pinf_inf=carry.pinf_inf, gap=carry.gap, grams=carry.grams)
        return ends.finish(out, ctrl)



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


_F64_STATE = ("pobj", "dobj", "pinf_l1", "pinf_inf", "gap", "rho",
              "cur_rho_max", "old_mean")
_INT_STATE = ("count", "bad_pd", "cg_total", "it", "code")


class _ChunkEnds:
    """The host's decisions where a chunk ends (the JAX package's
    ``parse_blob``) and where the loop ends, the same for the eager and
    the device-resident loop."""

    def __init__(self, phase: ADMMPhase, mode: str, iter_ceiling: int,
                 time_start: float, info: ADMMInfo, f64_check,
                 chunk_from: int, chunk: int):
        self.phase, self.mode, self.info = phase, mode, info
        self.iter_ceiling, self.time_start = iter_ceiling, time_start
        self.f64_check = f64_check
        self.chunk_from, self.chunk = chunk_from, chunk
        self.checks = f64_check is not None or (phase.f32 and mode == "main")
        self.last_f64_it = -10**9
        self.f64_every = 0
        self.plateau_chunks = 0
        self.plateau_prev_pinf = None
        self.f64 = None          # the float64 metrics of a float64 exit

    def stop(self, carry: ADMMCarry, ctrl: ADMMCtrl) -> bool:
        """At a chunk end (``ctrl.code`` RUN): the float64 re-check and the
        float32 plateau exit (past ``chunk_from``), the time limit and
        SIGINT.  True: the loop stops here."""
        ph, p, info = self.phase, self.phase.params, self.info
        if (self.checks and ctrl.it > self.chunk_from
                and ph._overall(carry, ctrl)
                and ctrl.it < self.iter_ceiling):
            if (self.f64_check is not None
                    and carry.pinf_l1 <= p.phase2_tol
                    and carry.gap <= 1e4 * p.phase2_tol
                    and ctrl.it - self.last_f64_it >= self.f64_every):
                # plausibly converged, but the float32 device gap may not
                # resolve it: re-evaluate the iterate in float64
                f64 = self.f64_check(carry)
                self.last_f64_it = ctrl.it
                if f64[4] <= p.phase2_tol and f64[2] <= p.phase2_tol:
                    self.f64 = f64
                    return True
                self.f64_every = CHUNK if f64[4] <= 10 * p.phase2_tol \
                    else 4 * CHUNK
            if ph.f32 and self.mode == "main":
                # precision plateau: near-feasible chunks whose pinf
                # stopped improving, never certifying
                near = carry.pinf_l1 <= 1e2 * p.phase2_tol
                non_improving = (self.plateau_prev_pinf is not None
                                 and carry.pinf_l1
                                 >= 0.98 * self.plateau_prev_pinf)
                self.plateau_chunks = (self.plateau_chunks + 1
                                       if near and non_improving else 0)
                self.plateau_prev_pinf = carry.pinf_l1
                if self.plateau_chunks >= max(2, (6 * 25) // self.chunk):
                    info.plateau = True
                    return True
        time_up, intr = ph.agree(
            time.time() - self.time_start >= p.time_sec_limit,
            interrupt.interrupted())
        if time_up:
            info.time_limit = True
            return True
        if intr:
            info.interrupted = True
            return True
        return False

    def finish(self, carry: ADMMCarry, ctrl: ADMMCtrl) -> ADMMCarry:
        """Sets ``ctrl.code`` on a natural exit and fills ``info``."""
        ph, info = self.phase, self.info
        if ctrl.code == CODE_RUN and not (info.time_limit or info.interrupted
                                          or info.plateau or self.f64):
            ctrl.code = (CODE_DONE if not ph._overall(carry, ctrl)
                         else CODE_CEILING)
        info.iters = ctrl.it
        info.cg_iters_total = ctrl.cg_total
        if self.f64:
            # the whole host-mirror metric set in one precision
            info.converged = True
            (info.last_pobj, info.last_dobj, info.last_pinf,
             info.last_pinf_inf, info.last_gap) = self.f64
        else:
            info.last_gap, info.last_pinf = carry.gap, carry.pinf_l1
            info.last_pinf_inf = carry.pinf_inf
            info.last_pobj, info.last_dobj = carry.pobj, carry.dobj
        info.num_err = ctrl.code == CODE_NUM_ERR
        info.bad_iter = ctrl.code == CODE_BAD_ITER
        return carry
