"""End-to-end parity of the port's solver with the JAX package's on
generated MaxCut problems and on a generated matrix-completion problem
(sparse constraints), both started from the JAX package's own R0.

The JAX solver draws its starting factors (``init_factors``,
``PRNGKey(seed)``) and its Lanczos start vectors (``fold_in(PRNGKey(7),
i)``) in its internal, relabeled row order; the test maps both to the
problem's original order and hands them to the port's ``Solver.solve``.

Tolerances (float64): ALM stats rows 1e-8 relative; final pobj and dobj
1e-6 relative; ALM outer and inner iteration counts exact; ADMM iteration
counts exact, with at most +-1 allowed when a stopping test compares a
value within rounding of its threshold (the message then names the first
ADMM iteration whose metrics differ).  Matrix completion: a well-sampled
instance whose solve needs no reopt round (``MC_EXACT``) is held to all of
the above, exactly like the MaxCut cases; the thinly sampled one, whose
reopt round amplifies rounding, is the stress case: what it leaves
reproducible is held exactly and the rest is bounded, with the bounds and
their reason stated at ``MC_INNER_SLACK``.

Multi-block problems, dense objectives and the LP cone are held to the same
terms in ``test_torch_families.py``.
"""

import json
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.config import SolverParams as JaxSolverParams
from ltr_lowrank_sdp_tpu.problem import load_problem as jax_load_problem
from ltr_lowrank_sdp_tpu.solver import alm as jax_alm
from ltr_lowrank_sdp_tpu.solver.common import init_factors as jax_init_factors
from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
from ltr_lowrank_sdp_tpu.solver.logging import (
    TrajectoryLogger as JaxTrajectoryLogger)
from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state as jax_rank_state
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_random_maxcut_problem)
from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
from ltr_lowrank_sdp_torch.solver import alm
from ltr_lowrank_sdp_torch.solver.common import HostSync
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.solver.logging import TrajectoryLogger
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.problem import initial_ranks
from ltr_lowrank_sdp_torch.testing import (matcomp_problem, matcomp_sdpa,
                                           random_maxcut_problem, write_sdpa)

# (n, avg_degree, seed, params): the default flags (ALM does most of the
# work) and the delaunay_n14 flags of the LoRADS MaxCut row (phase1Tol 10,
# heuristicFactor 100: ADMM does most of the work)
CASES = {
    "seed2-default": (200, 4, 2, {}),
    "seed5-admm": (300, 3, 5, {"phase1_tol": 10.0,
                               "heuristic_factor": 100.0}),
}
# a matrix completion (sparse constraints) held to the same exact parity as
# the MaxCut cases: ``matcomp_problem(200, 200, 2, 1.5, seed=0)``, n = 400,
# m = 7189 one-entry constraints, sampled well enough that the solve needs no
# reopt round (7 ALM outer / 43 inner, 8 ADMM, 184 CG iterations)
MC_EXACT = "mc200-sf1.5"
MC_EXACT_ARGS = (200, 200, 2, 1.5, 0)


class _Case:
    def __init__(self, n, deg, seed, kw, tmp):
        self._setup(jax_random_maxcut_problem(n, avg_degree=deg, seed=seed),
                    random_maxcut_problem(n, avg_degree=deg, seed=seed),
                    kw, tmp)

    def _setup(self, jprob, prob, kw, tmp):
        self.jprob = jprob
        self.prob = prob
        self.jparams = JaxSolverParams(**kw)
        self.params = SolverParams(**kw)
        self.jsolver = JaxSolver(self.jprob, self.jparams)
        ops = self.jsolver.cones[0]
        ranks = jax_rank_state(self.jprob, self.jparams).ranks
        R0, _ = jax_init_factors(ranks, self.jprob.block_dims, 0,
                                 jax.random.PRNGKey(self.jparams.seed),
                                 jnp.float64)
        self.R0_internal = R0
        self.R0 = [ops.permute_rows_out(np.asarray(r)) for r in R0]
        key7 = jax.random.PRNGKey(7)
        self.v0 = [ops.permute_rows_out(np.asarray(jax.random.normal(
            jax.random.fold_in(key7, i), (c.n,), jnp.float64)))
            for i, c in enumerate(self.jsolver.cones)]
        self.tmp = tmp
        self._solved = None

    def solved(self):
        if self._solved is None:
            jrows, trows = [], []
            jlog = JaxTrajectoryLogger(self.jparams, verbose=False)
            tlog = TrajectoryLogger(self.params, verbose=False)
            _capture_admm_rows(jlog, jrows)
            _capture_admm_rows(tlog, trows)
            jjson, tjson = self.tmp / "jax.json", self.tmp / "torch.json"
            jres = self.jsolver.solve(logger=jlog, json_path=str(jjson))
            tres = Solver(self.prob, self.params, device="cpu").solve(
                logger=tlog, json_path=str(tjson),
                init_factors=self.R0, lanczos_start=self.v0)
            self._solved = (jres, tres, jrows, trows,
                            json.loads(jjson.read_text()),
                            json.loads(tjson.read_text()))
        return self._solved


def _capture_admm_rows(logger, rows):
    record = logger.record_admm_row

    def wrapped(stat_row, grams, it, *a):
        rows.append((it, [float(x) for x in stat_row[:7]]))
        return record(stat_row, grams, it, *a)

    logger.record_admm_row = wrapped


@pytest.fixture(scope="module", params=sorted(CASES) + [MC_EXACT])
def case(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    if request.param == MC_EXACT:
        return _MatcompCase(tmp, MC_EXACT_ARGS)
    n, deg, seed, kw = CASES[request.param]
    return _Case(n, deg, seed, kw, tmp)


def _alm_phase_both(case):
    """The main-mode ALM phase alone on both sides from the same R0:
    ``(jinfo, tinfo, jrows, trows)``."""
    p = case.params
    ranks = [int(r.shape[1]) for r in case.R0]
    shapes = [(n, r) for n, r in zip(case.prob.block_dims, ranks)]
    rho0 = 1.0 / np.sqrt(sum(case.prob.block_dims))

    jphase, _ = case.jsolver.phases(ranks)
    jcarry = jax_alm.make_alm_carry(case.R0_internal, None, case.jprob.m,
                                    jphase.n_elems, rho0, case.jparams,
                                    jnp.float64)
    jrows = []
    _, jinfo = jphase.run(jcarry, 1, time.time(),
                          record_cb=lambda row, k, i, g: jrows.append(
                              [float(x) for x in np.asarray(row)[:10]]))

    tsolver = Solver(case.prob, p, device="cpu")
    sync = HostSync()
    tphase = alm.ALMPhase(tsolver.cones, tsolver.b, tsolver.consts, p,
                          shapes, sync)
    R0 = tuple(torch.tensor(r) for r in case.R0)
    tcarry = alm.make_alm_carry(R0, case.prob.m, tphase.n_elems, rho0, p)
    trows = []
    _, tinfo = tphase.run(tcarry, 1, time.time(),
                          record_cb=lambda row, k, i, g: trows.append(row))
    return jinfo, tinfo, np.asarray(jrows), np.asarray(trows)


def test_alm_phase_matches_jax(case):
    """The main-mode ALM phase alone, same R0: same exit, same counts, same
    per-outer-iteration stats rows."""
    jinfo, tinfo, jrows, trows = _alm_phase_both(case)
    assert (tinfo.converged, tinfo.num_err, tinfo.escalate) == (
        jinfo.converged, jinfo.num_err, jinfo.escalate)
    assert (tinfo.outer_iter, tinfo.inner_iter) == (jinfo.outer_iter,
                                                    jinfo.inner_iter)
    assert len(trows) == len(jrows) > 0
    np.testing.assert_allclose(trows, jrows, rtol=1e-8, atol=1e-12)


def test_solve_status_and_ranks_match_jax(case):
    jres, tres = case.solved()[:2]
    assert tres.status == SolverStatus(jres.status.value)
    assert tres.status == SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert tres.final_ranks == jres.final_ranks
    assert tres.oracle_rank == jres.oracle_rank


def test_solve_objectives_match_jax(case):
    jres, tres = case.solved()[:2]
    assert tres.pobj == pytest.approx(jres.pobj, rel=1e-6)
    assert tres.dobj == pytest.approx(jres.dobj, rel=1e-6)
    assert tres.dinf_l1 == pytest.approx(jres.dinf_l1, rel=1e-6, abs=1e-12)
    # the returned factors and duals are in the problem's original order
    np.testing.assert_allclose(tres.dual, jres.dual, rtol=1e-6, atol=1e-9)


def test_solve_iteration_counts_match_jax(case):
    jres, tres, jrows, trows = case.solved()[:4]
    assert tres.alm_outer_iters == jres.alm_outer_iters
    assert tres.alm_inner_iters == jres.alm_inner_iters
    d = tres.admm_iters - jres.admm_iters
    where = (f"the ADMM rows agree up to iteration "
             f"{min(len(jrows), len(trows))}, where one side stops")
    for (jit, jrow), (tit, trow) in zip(jrows, trows):
        if not np.allclose(jrow, trow, rtol=1e-6, atol=1e-12):
            where = (f"first differing ADMM iteration {jit}: jax {jrow} "
                     f"torch {trow}")
            break
    assert abs(d) <= 1, (tres.admm_iters, jres.admm_iters, where)
    if d:
        warnings.warn(f"ADMM iteration counts differ by {d}: {where}")
    else:
        assert tres.cg_iters == jres.cg_iters


def test_trajectory_json_matches_jax(case):
    jjson, tjson = case.solved()[4:]
    assert set(tjson) == set(jjson) == {"problem_id", "file_path", "metrics",
                                        "trajectory"}
    assert set(tjson["metrics"]) == set(jjson["metrics"])
    for phase in ("phase_1", "phase_2"):
        assert set(tjson["trajectory"][phase]) == set(
            jjson["trajectory"][phase])
        assert tjson["trajectory"][phase]["curr_rank"] == \
            jjson["trajectory"][phase]["curr_rank"]
        assert tjson["trajectory"][phase]["oracle_rank"] == \
            jjson["trajectory"][phase]["oracle_rank"]


def test_default_start_is_seeded():
    """Without injected factors the port draws R0 and the Lanczos start
    vectors from ``torch.Generator`` seeds: two solves agree exactly."""
    prob = random_maxcut_problem(80, avg_degree=4, seed=1)
    params = SolverParams(max_admm_iter=30)
    a = Solver(prob, params, device="cpu").solve()
    b = Solver(prob, params, device="cpu").solve()
    assert (a.pobj, a.dobj, a.admm_iters, a.host_syncs) == (
        b.pobj, b.dobj, b.admm_iters, b.host_syncs)
    assert a.host_syncs > 0


def test_float32_and_feasibility_paths_raise():
    """An unknown dtype raises.  The C = 0 feasibility path, which raised
    here until its slice, now takes the JAX driver's ``feas_only`` path
    (phase 1 tightened to the final bar; the solves are held to the JAX
    package's in ``test_torch_feasibility.py``); the float32 half of this
    test became ``test_float32_path_solves`` with its slice."""
    prob = random_maxcut_problem(40, avg_degree=4, seed=0)
    prob.c_nrm1 = 0.0
    s = Solver(prob, device="cpu")
    assert s.feas_only
    assert s.params.phase1_tol == min(
        SolverParams().phase1_tol,
        SolverParams().phase2_tol * (1.0 + prob.b_nrminf) / (1.0 + prob.b_nrm1))
    with pytest.raises(ValueError, match="unknown dtype"):
        Solver(random_maxcut_problem(40, avg_degree=4, seed=0),
               SolverParams(dtype="float16"), device="cpu")


def test_float32_path_solves():
    """``dtype="float32"`` builds float32 operators and factors and
    certifies; ``"auto"`` stays float64."""
    prob = random_maxcut_problem(40, avg_degree=4, seed=0)
    s32 = Solver(prob, SolverParams(dtype="float32"), device="cpu")
    assert s32.dtype == torch.float32 and s32.b.dtype == torch.float32
    assert Solver(prob, device="cpu").dtype == torch.float64
    res = s32.solve()
    assert res.status == SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert res.U[0].dtype == res.dual.dtype == np.float32
    assert "f64_polish" in res.stage_times and "polish2" in res.stage_times


# --------------------------------------------------------------------------- #
# matrix completion: sparse constraints, sparse objective
# --------------------------------------------------------------------------- #

MC_ARGS = (200, 200, 2, 1.0, 0)     # n = 400, m = 4793, one entry each
MC_KW = {"heuristic_factor": 10.0}
# The stress case (the exact one is ``MC_EXACT`` above).  What rounding moves
# on this instance.  The main-mode ALM phase (8 outer,
# 190 inner iterations), the ADMM phase (4 iterations, 71 CG iterations) and
# the ALM outer count agree exactly with the JAX solver.  The reopt ALM round
# after them is one L-BFGS sub-solve of 2,100 to 2,400 iterations at a
# stalled gradient norm, and it amplifies rounding (1e-16 relative per
# operator, from the two packages' different summation orders) into its
# iteration count and into the digits of the final iterate below the
# solver's own tolerances.  It does so inside either package alone: the
# port's total inner count is 2,510, 2,809 and 2,525 with 1, 2 and 8 torch
# threads, its oracle rank 3, 2, 3, and the JAX solver's count moves from
# 2,523 to 2,800 when b changes in its 16th digit (the instance read from a
# file written with 16 digits).  So the solve below runs on one torch thread
# (one summation order), and it holds:
# - total ALM inner iterations within 15 % of the JAX solver's;
# - pobj to 1e-6 relative (the iterate is feasible to 3e-8, which pins it);
# - dobj within the two solves' own certified gaps of that:
#   |dobj - dobj'| <= (gap + gap')(1 + |pobj| + |dobj|) + 1e-6 |pobj|
#   (1e-6 relative fails: 799.8025 against 799.8041, both with gap <= 1e-6);
# - no oracle-rank equality.
MC_INNER_SLACK = 0.15


class _MatcompCase(_Case):
    def __init__(self, tmp, args):
        path = tmp / "mc200.dat-s"
        write_sdpa(path, matcomp_sdpa(*args))
        self._setup(jax_load_problem(str(path)),
                    matcomp_problem(*args, name="mc200"), MC_KW, tmp)

    def solved(self):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return super().solved()
        finally:
            torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mc(tmp_path_factory):
    return _MatcompCase(tmp_path_factory.mktemp("matcomp"), MC_ARGS)


def test_matcomp_problem_is_the_same_on_both_sides(mc):
    jc, tc = mc.jprob.cones[0], mc.prob.cones[0]
    for name in ("c_rows", "c_cols", "c_vals", "a_rows", "a_cols", "a_vals",
                 "a_cid"):
        np.testing.assert_array_equal(getattr(jc, name), getattr(tc, name))
    np.testing.assert_array_equal(mc.jprob.b, mc.prob.b)
    assert (jc.kind_a, jc.kind_c) == (tc.kind_a, tc.kind_c) == ("sparse",
                                                                "sparse")
    assert (tc.n, mc.prob.m) == (400, 4793)
    assert initial_ranks(mc.prob) == ([12], [98])
    # the JAX solver keeps this family's rows and constraints in order
    assert mc.jsolver.constr_order is None
    tsolver = Solver(mc.prob, mc.params, device="cpu")
    assert tsolver.constr_order is None
    np.testing.assert_array_equal(tsolver.b.numpy(), mc.prob.b)


def test_matcomp_alm_phase_matches_jax(mc):
    """Same exit, same counts, same stats rows to 1e-6 relative (they agree
    to 1e-8 until the last row, 190 L-BFGS iterations in, where the primal
    infeasibility of 1.7e-6 differs by 2e-8 relative).  The gap
    column |pobj - dobj| / (1 + |pobj| + |dobj|) is a difference of two
    objectives near 800 that agree to about 1e-13 relative, so it is held to
    1e-9 absolute (it is about 5e-5 at the exit) instead."""
    jinfo, tinfo, jrows, trows = _alm_phase_both(mc)
    assert (tinfo.converged, tinfo.num_err, tinfo.escalate) == (
        jinfo.converged, jinfo.num_err, jinfo.escalate)
    assert (tinfo.outer_iter, tinfo.inner_iter) == (jinfo.outer_iter,
                                                    jinfo.inner_iter)
    assert tinfo.inner_iter == 190 and len(trows) == len(jrows) == 8
    gap_col = 8
    rest = [c for c in range(jrows.shape[1]) if c != gap_col]
    np.testing.assert_allclose(trows[:, rest], jrows[:, rest], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(trows[:, gap_col], jrows[:, gap_col], rtol=0,
                               atol=1e-9)


def test_matcomp_solve_matches_jax(mc):
    K.reset_counts()
    jres, tres = mc.solved()[:2]
    counts = K.counts()
    assert tres.status == SolverStatus(jres.status.value)
    assert tres.status == SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert tres.final_ranks == jres.final_ranks == [12]
    assert tres.pobj == pytest.approx(jres.pobj, rel=1e-6)
    scale = 1.0 + abs(jres.pobj) + abs(jres.dobj)
    assert abs(tres.dobj - jres.dobj) <= (
        (tres.gap + jres.gap) * scale + 1e-6 * abs(jres.pobj))
    assert tres.pinf_l1 <= 1e-5 and tres.gap <= 5e-5 and tres.dinf_l1 <= 5e-5
    # the sparse-cone solve runs K1, K4, K5, K6 (their plain versions here)
    # and never the MaxCut row kernels
    assert all(launches == 0 for launches, _ in counts.values())
    assert {n for n, (_, plain) in counts.items() if plain} == {
        "spmm_sym_csr", "sym_contract_sum", "coo_contract_segsum",
        "spmm_constr_csr"}


def test_matcomp_iteration_counts_match_jax(mc):
    jres, tres, jrows, trows = mc.solved()[:4]
    assert tres.alm_outer_iters == jres.alm_outer_iters == 11
    assert abs(tres.alm_inner_iters - jres.alm_inner_iters) <= (
        MC_INNER_SLACK * jres.alm_inner_iters)
    assert (tres.admm_iters, tres.cg_iters) == (jres.admm_iters,
                                                jres.cg_iters)
    assert len(jrows) == len(trows)
    # ADMM stats rows (pobj, dobj, pinf, ..., rho, CG count): the gap
    # column cancels as in the ALM rows
    for (_, jrow), (_, trow) in zip(jrows, trows):
        np.testing.assert_allclose(trow[:4], jrow[:4], rtol=1e-6)
        np.testing.assert_allclose(trow[4], jrow[4], rtol=0, atol=1e-8)
        assert trow[5:] == jrow[5:]


def test_matcomp_trajectory_json_matches_jax(mc):
    jjson, tjson = mc.solved()[4:]
    assert set(tjson) == set(jjson) == {"problem_id", "file_path", "metrics",
                                        "trajectory"}
    assert set(tjson["metrics"]) == set(jjson["metrics"])
    for phase in ("phase_1", "phase_2"):
        jp, tp = jjson["trajectory"][phase], tjson["trajectory"][phase]
        assert set(tp) == set(jp)
        assert tp["curr_rank"] == jp["curr_rank"]
        assert len(tp["oracle_rank"]) == len(jp["oracle_rank"])
    # the rows of the main-mode ALM phase (before the reopt round) carry
    # the same oracle ranks
    assert tjson["trajectory"]["phase_1"]["oracle_rank"][:8] == \
        jjson["trajectory"]["phase_1"]["oracle_rank"][:8]
