"""End-to-end parity of the port's solver with the JAX package's on
problems with several SDP cones, dense objectives and an LP cone, on the
CPU, from the same starts.

Both packages get the same ``SDPAData`` arrays (or the same file), the JAX
package's own starting factor per cone (``init_factors``, ``PRNGKey(seed)``,
mapped from its internal row order to the problem's), its LP start vector
(``init_lp``) and its per-cone Lanczos start vectors (``fold_in(PRNGKey(7),
i)``).

``random_multiblock_problem()`` with the Gauss-Seidel and the Jacobi sweep
and the two-column SDP + LP file of ``tests/test_e2e.py`` are held exactly
(``FAMILY_EXACT``); the small multi-block + LP instance and a small Lovasz
theta problem, whose solves go through a reopt round or thousands of L-BFGS
iterations, with the bounds stated at ``FAMILY_BOUNDED``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.config import SolverParams as JaxSolverParams
from ltr_lowrank_sdp_tpu.io.sdpa import SDPABlock as JaxSDPABlock
from ltr_lowrank_sdp_tpu.io.sdpa import SDPAData as JaxSDPAData
from ltr_lowrank_sdp_tpu.problem import canonicalize as jax_canonicalize
from ltr_lowrank_sdp_tpu.problem import load_problem as jax_load_problem
from ltr_lowrank_sdp_tpu.solver import alm as jax_alm
from ltr_lowrank_sdp_tpu.solver.common import init_factors as jax_init_factors
from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state as jax_rank_state
from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.problem import canonicalize, load_problem
from ltr_lowrank_sdp_torch.solver import alm
from ltr_lowrank_sdp_torch.solver.common import HostSync
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.testing import (multiblock_lp_sdpa,
                                           random_multiblock_problem,
                                           theta_sdpa)

INNER_SLACK = 0.15

SDP_LP_TEXT = """\
2
2
2 -2
2.0 1.0
0 1 1 1 -1.0
0 1 2 2 -1.0
0 2 1 1 -2.0
0 2 2 2 -1.0
1 1 1 1 1.0
1 2 1 1 1.0
2 1 2 2 1.0
2 2 2 2 1.0
"""
# held to exact parity: same status, ranks, ALM outer / inner, ADMM and CG
# counts, pobj and dobj to 1e-6 relative
FAMILY_EXACT = ["multiblock-gs", "multiblock-jacobi", "sdp+lp"]
# What rounding moves on the other two.  ``multiblock_lp``
# (``multiblock_lp_sdpa(dims=(100, 80, 60), m=240, n_lp=2000, seed=0)``): the
# main-mode ALM phase (7 outer, 192 inner iterations, stats rows to 1e-6)
# and the main ADMM phase (13 iterations) agree; the reopt round that
# follows starts from iterates that differ in their ninth digit and ends when
# the gap first drops under 1e-5 on a tail that decays by 1e-7 per iteration
# (1.40e-5 to 1.33e-5 over four iterations in the JAX solve), so its counts
# move with the last digits: JAX 340 inner / 63 ADMM, port 348 / 17.
# ``theta`` (``theta_sdpa(40, 10, 40)``): 10,000 to 11,000 L-BFGS iterations
# with a rank escalation from 8 to 12 between them.  Held on both: status
# ``primal_dual_optimal``, final ranks, ALM outer count, the main-mode ALM
# phase up to its first exit (exact counts and rows; theta's inner count
# within ``INNER_SLACK``), total ALM inner iterations within ``INNER_SLACK``
# (15 %), and pobj and dobj each within the two solves' own certified gaps,
# |x - x'| <= (gap + gap')(1 + |pobj| + |dobj|) + 1e-6 |pobj|
# (theta's pobj values, -13.0000044 and -12.9999960, are 6.5e-7 apart, both
# within 2e-7 of their dobj).  The full solves' ADMM and CG counts are not
# compared.  ``multiblock_lp`` is also held at the point the two solves
# share, the end of the main ALM and ADMM phases (``reopt_level=0``): exact
# ALM and ADMM counts, pobj and dobj to 1e-6 relative
# (``test_multiblock_lp_main_phases_match_jax``).
FAMILY_BOUNDED = ["multiblock_lp", "theta"]


def _family_inputs(name, tmp):
    """``(jax problem, port problem, params kwargs)`` from the same arrays."""
    if name.startswith("multiblock-"):
        p = random_multiblock_problem()
        blocks = [JaxSDPABlock(dim=c.n, c_rows=c.c_rows, c_cols=c.c_cols,
                               c_vals=c.c_vals, a_rows=c.a_rows,
                               a_cols=c.a_cols, a_vals=c.a_vals,
                               a_cid=c.a_cid) for c in p.cones]
        data = JaxSDPAData(n_constrs=p.m, blocks=blocks, b=p.b)
        kw = {"admm_jacobi": True} if name.endswith("jacobi") else {}
        return jax_canonicalize(data, name=name), p, kw
    if name == "sdp+lp":
        path = tmp / "sdplp.dat-s"
        path.write_text(SDP_LP_TEXT)
        return jax_load_problem(str(path)), load_problem(str(path)), {}
    data = (multiblock_lp_sdpa(dims=(100, 80, 60), m=240, n_lp=2000, seed=0)
            if name == "multiblock_lp" else theta_sdpa(40, 10, 40))
    return jax_canonicalize(data, name=name), canonicalize(data, name=name), {}


class _FamilyCase:
    """Any number of cones and an optional LP cone: the JAX package's own
    starting factors per cone (mapped to the problem's row order), its LP
    start vector and its per-cone Lanczos start vectors."""

    def __init__(self, name, tmp):
        self.name = name
        jprob, prob, kw = _family_inputs(name, tmp)
        self.jprob, self.prob = jprob, prob
        self.jparams, self.params = JaxSolverParams(**kw), SolverParams(**kw)
        self.jsolver = JaxSolver(jprob, self.jparams)
        ranks = jax_rank_state(jprob, self.jparams).ranks
        R0, rlp0 = jax_init_factors(ranks, jprob.block_dims, jprob.n_lp_cols,
                                    jax.random.PRNGKey(self.jparams.seed),
                                    jnp.float64)
        self.R0_internal, self.rlp0_internal = R0, rlp0
        cones = self.jsolver.cones
        self.R0 = [ops.permute_rows_out(np.asarray(r))
                   for ops, r in zip(cones, R0)]
        self.rlp0 = None if rlp0 is None else np.asarray(rlp0)
        key7 = jax.random.PRNGKey(7)
        self.v0 = [ops.permute_rows_out(np.asarray(jax.random.normal(
            jax.random.fold_in(key7, i), (ops.n,), jnp.float64)))
            for i, ops in enumerate(cones)]
        self.tmp = tmp
        self._solved = None

    def solved(self):
        if self._solved is None:
            jres = self.jsolver.solve()
            tres = Solver(self.prob, self.params, device="cpu").solve(
                init_factors=self.R0, lanczos_start=self.v0,
                init_lp=self.rlp0)
            self._solved = (jres, tres)
        return self._solved


@pytest.fixture(scope="module", params=FAMILY_EXACT + FAMILY_BOUNDED)
def fcase(request, tmp_path_factory):
    return _FamilyCase(request.param,
                       tmp_path_factory.mktemp(request.param.replace("+", "")))


def _family_alm_phase_both(case):
    """The main-mode ALM phase alone on both sides from the same start."""
    p = case.params
    ranks = [int(r.shape[1]) for r in case.R0]
    shapes = [(n, r) for n, r in zip(case.prob.block_dims, ranks)]
    rho0 = 1.0 / np.sqrt(sum(case.prob.block_dims))
    jphase, _ = case.jsolver.phases(ranks)
    jcarry = jax_alm.make_alm_carry(
        case.R0_internal, case.rlp0_internal, case.jprob.m, jphase.n_elems,
        rho0, case.jparams, jnp.float64)
    jrows = []
    rank_state = jax_rank_state(case.jprob, case.jparams)
    kw = dict(is_rank_max=rank_state.is_rank_max,
              rank_thresh=rank_state.stall_threshold(case.jparams))
    _, jinfo = jphase.run(jcarry, 1, time.time(),
                          record_cb=lambda row, k, i, g: jrows.append(
                              [float(x) for x in np.asarray(row)[:10]]),
                          **kw)
    tsolver = Solver(case.prob, p, device="cpu")
    tphase = alm.ALMPhase(tsolver.cones, tsolver.b, tsolver.consts, p,
                          shapes, HostSync(), lp=tsolver.lp)
    assert (tphase.n_elems, tphase.inner_pass_cap) == (
        jphase.n_elems, jphase.inner_pass_cap)
    tcarry = alm.make_alm_carry(
        tuple(torch.tensor(r) for r in case.R0), case.prob.m, tphase.n_elems,
        rho0, p, rlp=None if case.rlp0 is None else torch.tensor(case.rlp0))
    trows = []
    _, tinfo = tphase.run(tcarry, 1, time.time(),
                          record_cb=lambda row, k, i, g: trows.append(row),
                          **kw)
    return jinfo, tinfo, np.asarray(jrows), np.asarray(trows)


def test_family_alm_phase_matches_jax(fcase):
    """Same exit (converged, or the first rank-escalation request), same
    counts; stats rows to 1e-6 relative, the gap column to 1e-9 absolute
    (a cancelling difference, as for matrix completion).  Theta leaves at
    its first rank-escalation request after some 1,300 L-BFGS iterations:
    its rows, one per outer iteration, are held like the others', and the
    inner count, which includes the last, unrecorded pass, within
    ``INNER_SLACK``."""
    jinfo, tinfo, jrows, trows = _family_alm_phase_both(fcase)
    assert (tinfo.converged, tinfo.num_err, tinfo.escalate) == (
        jinfo.converged, jinfo.num_err, jinfo.escalate)
    assert tinfo.outer_iter == jinfo.outer_iter
    assert len(trows) == len(jrows) > 0
    if fcase.name == "theta":
        assert abs(tinfo.inner_iter - jinfo.inner_iter) <= (
            INNER_SLACK * jinfo.inner_iter)
    else:
        assert tinfo.inner_iter == jinfo.inner_iter
    gap_col = 8
    rest = [c for c in range(jrows.shape[1]) if c != gap_col]
    np.testing.assert_allclose(trows[:, rest], jrows[:, rest], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(trows[:, gap_col], jrows[:, gap_col], rtol=0,
                               atol=1e-9)


def test_family_solve_matches_jax(fcase):
    jres, tres = fcase.solved()
    assert tres.status == SolverStatus(jres.status.value)
    assert tres.status == SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert tres.final_ranks == jres.final_ranks
    assert len(tres.final_ranks) == len(fcase.prob.cones)
    assert tres.alm_outer_iters == jres.alm_outer_iters
    assert tres.pinf_l1 <= 1e-5 and tres.gap <= 5e-5 and tres.dinf_l1 <= 5e-5
    if fcase.name in FAMILY_EXACT:
        assert tres.alm_inner_iters == jres.alm_inner_iters
        assert (tres.admm_iters, tres.cg_iters) == (jres.admm_iters,
                                                    jres.cg_iters)
        assert tres.pobj == pytest.approx(jres.pobj, rel=1e-6)
        assert tres.dobj == pytest.approx(jres.dobj, rel=1e-6)
        assert tres.dinf_l1 == pytest.approx(jres.dinf_l1, rel=1e-6,
                                             abs=1e-9)
    else:
        assert abs(tres.alm_inner_iters - jres.alm_inner_iters) <= (
            INNER_SLACK * jres.alm_inner_iters)
        bound = ((tres.gap + jres.gap)
                 * (1.0 + abs(jres.pobj) + abs(jres.dobj))
                 + 1e-6 * abs(jres.pobj))
        assert abs(tres.pobj - jres.pobj) <= bound
        assert abs(tres.dobj - jres.dobj) <= bound
    if fcase.name == "sdp+lp":
        # min tr(X) + 2 y1 + y2 with X_11 + y1 = 2, X_22 + y2 = 1: 3
        assert tres.pobj == pytest.approx(3.0, abs=1e-3)


def test_multiblock_lp_main_phases_match_jax(tmp_path):
    """Without the reopt rounds the small multi-block + LP solves end at the
    same point: ALM 7 outer / 192 inner, 13 ADMM iterations, pobj and dobj
    to 1e-6 relative (the gap there is 2e-4, so the status is ``maxiter`` on
    both sides).  CG totals are not compared: 1,849 against 1,847."""
    case = _FamilyCase("multiblock_lp", tmp_path)
    jres = JaxSolver(case.jprob, JaxSolverParams(reopt_level=0)).solve()
    tres = Solver(case.prob, SolverParams(reopt_level=0),
                  device="cpu").solve(init_factors=case.R0,
                                      lanczos_start=case.v0,
                                      init_lp=case.rlp0)
    assert tres.status == SolverStatus(jres.status.value)
    assert tres.final_ranks == jres.final_ranks
    assert (tres.alm_outer_iters, tres.alm_inner_iters, tres.admm_iters) == (
        jres.alm_outer_iters, jres.alm_inner_iters, jres.admm_iters) == (
        7, 192, 13)
    assert tres.pobj == pytest.approx(jres.pobj, rel=1e-6)
    assert tres.dobj == pytest.approx(jres.dobj, rel=1e-6)


def test_family_lp_factors_are_returned(fcase):
    jres, tres = fcase.solved()
    if fcase.prob.lp is None:
        assert tres.ulp is None and tres.vlp is None
        return
    n_lp = fcase.prob.n_lp_cols
    assert tres.ulp.shape == tres.vlp.shape == (n_lp,)
    # the LP columns x = u o v of the two solves: nonnegative up to the
    # tolerance, and the same point
    x, xj = tres.ulp * tres.vlp, np.asarray(jres.ulp) * np.asarray(jres.vlp)
    assert x.min() >= -1e-6
    np.testing.assert_allclose(x, xj, atol=1e-3 * max(1.0, np.abs(xj).max()))


def test_multiblock_lp_cpu_solve_takes_the_plain_versions():
    """A CPU solve of a multi-block + LP instance counts plain calls of
    K5 to K8 only (dense objectives go through ``torch.matmul``)."""
    prob = canonicalize(multiblock_lp_sdpa(dims=(20, 12), m=30, n_lp=40,
                                           seed=1))
    K.reset_counts()
    Solver(prob, SolverParams(max_alm_iter=2, max_admm_iter=2,
                              reopt_level=0), device="cpu").solve()
    counts = K.counts()
    assert all(launches == 0 for launches, _ in counts.values())
    assert {n for n, (_, plain) in counts.items() if plain} == {
        "coo_contract_segsum", "spmm_constr_csr", "lp_constr_segsum",
        "lp_col_wsum"}
