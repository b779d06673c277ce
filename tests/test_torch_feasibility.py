"""Pure-feasibility (C = 0) solves of the port against the JAX package's.

``tests/test_feasibility.py`` is the spec: a MaxCut problem with its
objective zeroed is always feasible (X = I), lambda = 0 is an exact optimal
dual, and the solve must return ``primal_dual_optimal`` with pobj = dobj =
gap = dinf = 0 exactly.  The port starts from the JAX solver's own factors
(mapped to the problem's row order) and must take the same path: phase 1
tightened to the same bar, the same counts and ranks, pinf to 1e-9.

Known reference defect, mirrored: an injected rank schedule still steers
the rank machinery of a C = 0 solve (``ROADMAP.md``, reference defects:
cphil12 under schedule injection, 211.9 s against 2.7 s); the port follows
the JAX driver there too, and the test only holds it to the JAX result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltr_lowrank_sdp_tpu.config import SolverParams as JaxSolverParams
from ltr_lowrank_sdp_tpu.solver.common import init_factors as jax_init_factors
from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state as jax_rank_state
from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem
from tests.test_feasibility import feasibility_problem as jax_feasibility


def feasibility_problem(n=30, seed=0):
    """The port's twin of ``tests/test_feasibility.py``'s problem."""
    prob = random_maxcut_problem(n, avg_degree=4, seed=seed)
    cones = [dataclasses.replace(c, c_vals=np.zeros_like(c.c_vals))
             for c in prob.cones]
    return dataclasses.replace(prob, cones=cones, c_nrm1=0.0, c_nrm2=0.0,
                               c_nrminf=0.0)


CASES = {
    "n30": (30, 0, {}),
    "n60-admm": (60, 3, {"phase1_tol": 10.0, "heuristic_factor": 100.0}),
    "n40-schedule": (40, 1, {"rank_schedule": (2, 3, 5)}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    n, seed, kw = CASES[request.param]
    jprob = jax_feasibility(n, seed)
    jparams = JaxSolverParams(disable_oracle=True, **kw)
    js = JaxSolver(jprob, jparams)
    ranks = jax_rank_state(jprob, js.params).ranks
    R0, _ = jax_init_factors(ranks, jprob.block_dims, 0,
                             jax.random.PRNGKey(jparams.seed), jnp.float64)
    ops = js.cones[0]
    key7 = jax.random.PRNGKey(7)
    v0 = [ops.permute_rows_out(np.asarray(jax.random.normal(
        jax.random.fold_in(key7, 0), (ops.n,), jnp.float64)))]
    ts = Solver(feasibility_problem(n, seed),
                SolverParams(disable_oracle=True, **kw), device="cpu")
    tres = ts.solve(init_factors=[ops.permute_rows_out(np.asarray(R0[0]))],
                    lanczos_start=v0)
    return js, js.solve(), ts, tres


def test_zero_dual_certificate(solved):
    _, _, ts, res = solved
    assert ts.feas_only
    assert res.status == SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert res.pobj == 0.0 and res.dobj == 0.0
    assert res.gap == 0.0 and res.dinf_l1 == 0.0
    assert res.pinf_l1 <= ts.params.phase2_tol


def test_matches_the_jax_solve(solved):
    js, jres, ts, tres = solved
    assert ts.params.phase1_tol == js.params.phase1_tol
    assert tres.status.value == jres.status.value
    assert tres.final_ranks == jres.final_ranks
    assert (tres.alm_outer_iters, tres.alm_inner_iters, tres.admm_iters) == (
        jres.alm_outer_iters, jres.alm_inner_iters, jres.admm_iters)
    assert tres.pinf_l1 == pytest.approx(jres.pinf_l1, rel=1e-6, abs=1e-12)
    assert (tres.pobj, tres.dobj, tres.gap, tres.dinf_l1) == (
        jres.pobj, jres.dobj, jres.gap, jres.dinf_l1)


def test_nonzero_objective_not_flagged():
    prob = random_maxcut_problem(30, avg_degree=4, seed=0)
    s = Solver(prob, SolverParams(), device="cpu")
    assert not s.feas_only and s.params == SolverParams()
