"""The port's float32 solve of an LP-cone problem against the JAX package's,
on the CPU: ``multiblock_lp_sdpa()`` at 1/10 scale (three SDP blocks of 100,
80 and 60 rows, 240 constraints, 2,000 LP columns).

The JAX float32 solve of this instance diverges: its ADMM CG asks for a
relative residual float32 cannot reach, stagnates near 4e-9, then grows to
1e-2 over its 800 iterations, and the next iterate is NaN or 1e8.  The
port's CG stops at the stagnation and keeps its best iterate (``ops/cg.py``,
a deviation from the reference), its ADMM stops near the tolerance and the
float64 polish certifies.  So this file holds the main-mode ALM phase from
the same float32 start against the JAX one (exact exit, outer and inner
counts, pobj to 1e-5 relative), and the port's certified float32 solve
against the JAX package's float64 solve: the same status and final ranks,
pobj to 5e-5 relative, and the float64 recomputation of the port's iterate
under pinf_l1 1e-5 and gap 5e-5.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.config import SolverParams as JaxSolverParams
from ltr_lowrank_sdp_tpu.solver import alm as jax_alm
from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
from ltr_lowrank_sdp_torch.config import SolverStatus
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.solver import alm
from ltr_lowrank_sdp_torch.solver.common import HostSync
from ltr_lowrank_sdp_torch.solver.driver import Solver
from test_torch_float32 import (F32, GAP_TOL, PINF_TOL, POBJ_RTOL, _Case,
                                _host_f64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's OpenMP workers spin after each parallel op and starve XLA's
    CPU threads in the same process; the sizes here need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lp_case(tmp_path_factory):
    return _Case("mblp", dict(F32), tmp_path_factory.mktemp("mblp"))


def test_lp_cone_float32_main_alm_phase_matches_jax(lp_case):
    """The main-mode ALM phase alone from the same float32 start: the same
    exit and the same outer and inner counts."""
    case = lp_case
    ranks = [int(r.shape[1]) for r in case.R0]
    shapes = [(n, r) for n, r in zip(case.prob.block_dims, ranks)]
    rho0 = 1.0 / np.sqrt(sum(case.prob.block_dims))
    jphase, _ = case.jsolver.phases(ranks)
    jcarry = jax_alm.make_alm_carry(case.R0_internal, case.rlp0_internal,
                                    case.jprob.m, jphase.n_elems, rho0,
                                    case.jparams, jnp.float32)
    _, jinfo = jphase.run(jcarry, 1, time.time())
    tsolver = Solver(case.prob, case.params, device="cpu")
    tphase = alm.ALMPhase(tsolver.cones, tsolver.b, tsolver.consts,
                          case.params, shapes, HostSync(), lp=tsolver.lp)
    R0 = tuple(torch.tensor(r) for r in case.R0)
    tcarry = alm.make_alm_carry(R0, case.prob.m, tphase.n_elems, rho0,
                                case.params, rlp=torch.tensor(case.rlp0))
    _, tinfo = tphase.run(tcarry, 1, time.time())
    assert (tinfo.converged, tinfo.num_err, tinfo.escalate) == (
        jinfo.converged, jinfo.num_err, jinfo.escalate)
    assert (tinfo.outer_iter, tinfo.inner_iter) == (jinfo.outer_iter,
                                                    jinfo.inner_iter)
    assert tinfo.pobj == pytest.approx(jinfo.pobj, rel=1e-5)


def test_lp_cone_float32_solve_certifies_against_jax_float64(lp_case):
    case = lp_case
    K.reset_counts()
    tres = case.port_solve()
    jres = JaxSolver(case.jprob, JaxSolverParams(disable_oracle=True)).solve()
    assert tres.status == SolverStatus(jres.status.value) == \
        SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert tres.final_ranks == jres.final_ranks
    assert tres.pobj == pytest.approx(jres.pobj, rel=POBJ_RTOL)
    assert tres.polish_runs >= 1
    pobj, dobj, pinf, _, gap = _host_f64(case.prob, tres)
    assert pinf <= PINF_TOL and gap <= GAP_TOL, (pinf, gap)
    counts = K.counts()
    assert counts["lp_constr_segsum"][1] > 0 and counts["lp_col_wsum"][1] > 0
