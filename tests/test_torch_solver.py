"""End-to-end parity of the port's solver with the JAX package's on
generated MaxCut problems, both started from the JAX package's own R0.

The JAX solver draws its starting factors (``init_factors``,
``PRNGKey(seed)``) and its Lanczos start vectors (``fold_in(PRNGKey(7),
i)``) in its internal, relabeled row order; the test maps both to the
problem's original order and hands them to the port's ``Solver.solve``.

Tolerances (float64): ALM stats rows 1e-8 relative; final pobj and dobj
1e-6 relative; ALM outer and inner iteration counts exact; ADMM iteration
counts exact, with at most +-1 allowed when a stopping test compares a
value within rounding of its threshold (the message then names the first
ADMM iteration whose metrics differ).
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
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem

# (n, avg_degree, seed, params): the default flags (ALM does most of the
# work) and the delaunay_n14 flags of the LoRADS MaxCut row (phase1Tol 10,
# heuristicFactor 100: ADMM does most of the work)
CASES = {
    "seed2-default": (200, 4, 2, {}),
    "seed5-admm": (300, 3, 5, {"phase1_tol": 10.0,
                               "heuristic_factor": 100.0}),
}


class _Case:
    def __init__(self, n, deg, seed, kw, tmp):
        self.jprob = jax_random_maxcut_problem(n, avg_degree=deg, seed=seed)
        self.prob = random_maxcut_problem(n, avg_degree=deg, seed=seed)
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


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    n, deg, seed, kw = CASES[request.param]
    return _Case(n, deg, seed, kw, tmp_path_factory.mktemp(request.param))


def test_alm_phase_matches_jax(case):
    """The main-mode ALM phase alone, same R0: same exit, same counts, same
    per-outer-iteration stats rows."""
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

    assert (tinfo.converged, tinfo.num_err, tinfo.escalate) == (
        jinfo.converged, jinfo.num_err, jinfo.escalate)
    assert (tinfo.outer_iter, tinfo.inner_iter) == (jinfo.outer_iter,
                                                    jinfo.inner_iter)
    assert len(trows) == len(jrows) > 0
    np.testing.assert_allclose(np.asarray(trows), np.asarray(jrows),
                               rtol=1e-8, atol=1e-12)


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
    prob = random_maxcut_problem(40, avg_degree=4, seed=0)
    with pytest.raises(NotImplementedError, match="later slice"):
        Solver(prob, SolverParams(dtype="float32"), device="cpu")
    prob.c_nrm1 = 0.0
    with pytest.raises(NotImplementedError, match="later slice"):
        Solver(prob, device="cpu")
