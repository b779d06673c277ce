"""The device-resident loops as CUDA graphs on the card (``-m cuda``; they
skip without a GPU): each solve with its ALM inner passes and ADMM chunks
replayed as graphs with conditional nodes against the same solve through
the eager loops on the same card, bit for bit, with the eager loops' launch
counts (the graphs' accounted ones) and fewer host reads.  No JAX here: the
card's machine has none (run with ``--noconftest``).

    python -m pytest --noconftest tests/test_torch_devloop_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.config import SolverParams
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.problem import load_problem
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.testing import (matcomp_sdpa, multiblock_lp_sdpa,
                                           random_maxcut_problem, write_sdpa)

cuda = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    K.build_kernels()
    return torch.device("cuda", torch.cuda.current_device())


def _case(kind, tmp_path):
    if kind == "mblp":
        path = tmp_path / "mblp.dat-s"
        write_sdpa(path, multiblock_lp_sdpa((14, 12, 10), 40, 60, seed=1))
        return load_problem(str(path)), SolverParams()
    if kind == "matcomp-f32":
        path = tmp_path / "mc.dat-s"
        write_sdpa(path, matcomp_sdpa(30, 30, 2, 1.0, 0))
        return load_problem(str(path)), SolverParams(
            dtype="float32", heuristic_factor=10.0, host_f64_verify=True)
    return (random_maxcut_problem(48, avg_degree=5, seed=7),
            SolverParams(phase1_tol=0.1))


@cuda
@pytest.mark.parametrize("kind", ["maxcut", "mblp", "matcomp-f32"])
def test_graphs_give_the_eager_loops_bits_on_the_card(kind, dev, tmp_path):
    prob, params = _case(kind, tmp_path)
    out = {}
    for device_loops in (False, True):
        sv = Solver(prob, params, device=dev)
        sv.device_loops = device_loops
        K.reset_counts()
        res = sv.solve()
        out[device_loops] = (res, K.counts(), K.counts_f32())
    (e, ec, ef), (d, dc, df) = out[False], out[True]
    for f in ("status", "pobj", "dobj", "alm_inner_iters", "admm_iters",
              "cg_iters", "final_ranks"):
        assert getattr(e, f) == getattr(d, f), f
    assert all(np.array_equal(x, y) for x, y in zip(e.U, d.U))
    assert ec == dc and ef == df
    assert d.graph_replays > 0 and d.host_syncs < e.host_syncs
