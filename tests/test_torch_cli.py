"""The port's CLI and readers on the CPU: generated SDPA ``.dat-s`` files
(MaxCut, matrix completion, a multi-block problem with an LP block, Lovasz
theta) and a SuiteSparse-style ``.mat`` MaxCut file are read into the same ``SDPProblem`` as the JAX package reads, solved through
``ltr_lowrank_sdp_torch.cli.main(..., "--device", "cpu")``, and the
trajectory JSON is written with the schema of the JAX package."""

import json

import numpy as np
import pytest
import scipy.io
import torch

from ltr_lowrank_sdp_tpu import cli as jax_cli
from ltr_lowrank_sdp_tpu.problem import load_problem as jax_load_problem
from ltr_lowrank_sdp_torch import cli
from ltr_lowrank_sdp_torch.config import SolverStatus
from ltr_lowrank_sdp_torch.problem import initial_ranks, load_problem
from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                           matcomp_problem, matcomp_sdpa,
                                           multiblock_lp_problem,
                                           multiblock_lp_sdpa, theta_problem,
                                           theta_sdpa, write_sdpa)

CONE_FIELDS = ("c_rows", "c_cols", "c_vals", "a_rows", "a_cols", "a_vals",
               "a_cid", "diag_idx", "diag_val", "diag_cid")


def _write_maxcut_dat_s(path, n, seed):
    """MaxCut SDP of a random graph in SDPA sparse format: maximize
    <L/4, X> s.t. X_ii = 1 (the reader negates the objective)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, 3 * n)
    v = rng.integers(0, n, 3 * n)
    keep = u < v
    edges = sorted(set(zip(u[keep].tolist(), v[keep].tolist())))
    deg = np.zeros(n)
    for a, b in edges:
        deg[a] += 1
        deg[b] += 1
    lines = ["* generated MaxCut instance", str(n), "1", str(n),
             " ".join(["1"] * n)]
    lines += [f"0 1 {i + 1} {i + 1} {deg[i] / 4.0}" for i in range(n)
              if deg[i]]
    lines += [f"0 1 {a + 1} {b + 1} -0.25" for a, b in edges]
    lines += [f"{i + 1} 1 {i + 1} {i + 1} 1.0" for i in range(n)]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def dat_s(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "maxcut150.dat-s"
    _write_maxcut_dat_s(path, 150, seed=3)
    return path


@pytest.fixture(scope="module")
def mat(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "delaunay200.mat"
    scipy.io.savemat(str(path),
                     {"Problem": {"A": delaunay_maxcut_adjacency(200, 5)}})
    return path


@pytest.fixture(scope="module")
def mc_dat_s(tmp_path_factory):
    """Matrix completion of a 200 x 200 rank-2 matrix: n = 400, 4793
    one-entry constraints (sparse constraints, sparse objective)."""
    path = tmp_path_factory.mktemp("cli") / "mc200.dat-s"
    write_sdpa(path, matcomp_sdpa(200, 200, 2, 1.0, seed=0))
    return path


MB_LP_ARGS = dict(dims=(30, 24, 20), m=40, n_lp=120, seed=4)


@pytest.fixture(scope="module")
def mblp_dat_s(tmp_path_factory):
    """Three coupled dense-objective blocks and an LP block of 120 columns,
    written last as a block of dimension -120."""
    path = tmp_path_factory.mktemp("cli") / "mblp.dat-s"
    write_sdpa(path, multiblock_lp_sdpa(**MB_LP_ARGS))
    return path


@pytest.fixture(scope="module")
def theta_dat_s(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "theta30.dat-s"
    write_sdpa(path, theta_sdpa(30, 8, seed=30))
    return path


@pytest.mark.parametrize("which", ["dat_s", "mat", "mc_dat_s", "mblp_dat_s",
                                   "theta_dat_s"])
def test_reader_matches_jax(which, request):
    path = str(request.getfixturevalue(which))
    jp, tp = jax_load_problem(path), load_problem(path)
    assert (tp.m, tp.name, tp.n_cones) == (jp.m, jp.name, jp.n_cones)
    np.testing.assert_array_equal(tp.b, jp.b)
    for jc, tc in zip(jp.cones, tp.cones):
        assert (tc.kind_a, tc.kind_c) == (jc.kind_a, jc.kind_c)
        for name in CONE_FIELDS:
            np.testing.assert_array_equal(getattr(tc, name),
                                          getattr(jc, name))
    for name in ("c_nrm1", "c_nrm2", "c_nrminf", "b_nrm1", "b_nrminf"):
        assert getattr(tp, name) == getattr(jp, name)
    assert initial_ranks(tp) == initial_ranks(jp)
    assert tp.n_lp_cols == jp.n_lp_cols
    if tp.lp is not None:
        for name in ("c", "col", "cid", "vals", "nrm2sq"):
            np.testing.assert_array_equal(getattr(tp.lp, name),
                                          getattr(jp.lp, name))


@pytest.mark.parametrize("which", ["dat_s", "mat"])
def test_cli_solves_on_cpu_and_writes_json(which, request, tmp_path):
    path = str(request.getfixturevalue(which))
    out = tmp_path / "sol.json"
    res = cli.main([path, "--device", "cpu", "--jsonfile", str(out)])
    assert res.status == SolverStatus.PRIMAL_DUAL_OPTIMAL
    assert res.pinf_l1 <= 1e-5 and res.gap <= 5e-5 and res.dinf_l1 <= 5e-5
    payload = json.loads(out.read_text())
    assert set(payload) == {"problem_id", "file_path", "metrics",
                            "trajectory"}
    assert payload["file_path"] == path
    assert payload["metrics"]["primal_obj"] == pytest.approx(res.pobj)
    p1 = payload["trajectory"]["phase_1"]
    assert len(p1["curr_rank"]) == len(p1["oracle_rank"]) > 0


def test_written_matcomp_file_reads_back_identical(mc_dat_s):
    mem = matcomp_problem(200, 200, 2, 1.0, seed=0)
    got = load_problem(str(mc_dat_s))
    np.testing.assert_array_equal(got.b, mem.b)
    for name in CONE_FIELDS[:7]:
        np.testing.assert_array_equal(getattr(got.cones[0], name),
                                      getattr(mem.cones[0], name))
    assert (got.cones[0].kind_a, got.cones[0].kind_c) == ("sparse", "sparse")


def test_cli_solves_matrix_completion_on_cpu(mc_dat_s, tmp_path):
    """The flags of the JAX package's own matrix-completion test
    (``tests/test_e2e.py``: heuristicFactor 10) and its limits."""
    out = tmp_path / "mc.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # no faster with more at this size
    try:
        res = cli.main([str(mc_dat_s), "--device", "cpu",
                        "--heuristicFactor", "10", "--jsonfile", str(out)])
    finally:
        torch.set_num_threads(threads)
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    assert res.pinf_l1 <= 1e-5 and res.gap <= 5e-5 and res.dinf_l1 <= 5e-5
    assert res.final_ranks == [12]
    payload = json.loads(out.read_text())
    assert set(payload) == {"problem_id", "file_path", "metrics",
                            "trajectory"}
    assert payload["problem_id"] == "mc200"
    assert payload["metrics"]["primal_obj"] == pytest.approx(res.pobj)
    assert set(payload["trajectory"]) == {"phase_1", "phase_2"}


@pytest.mark.parametrize("which", ["mblp_dat_s", "theta_dat_s"])
def test_written_family_file_reads_back_identical(which, request):
    mem = (multiblock_lp_problem(**MB_LP_ARGS) if which == "mblp_dat_s"
           else theta_problem(30, 8, seed=30))
    got = load_problem(str(request.getfixturevalue(which)))
    np.testing.assert_array_equal(got.b, mem.b)
    assert got.n_cones == mem.n_cones == (3 if which == "mblp_dat_s" else 1)
    for gc, mc in zip(got.cones, mem.cones):
        for name in CONE_FIELDS[:7]:
            np.testing.assert_array_equal(getattr(gc, name),
                                          getattr(mc, name))
        assert (gc.kind_a, gc.kind_c) == ("dense", "dense")
    if which == "mblp_dat_s":
        assert got.n_lp_cols == 120
        for name in ("c", "col", "cid", "vals"):
            np.testing.assert_array_equal(getattr(got.lp, name),
                                          getattr(mem.lp, name))


def test_cli_solves_multiblock_with_lp_block_on_cpu(mblp_dat_s, tmp_path,
                                                    capsys):
    out = tmp_path / "mblp.json"
    res = cli.main([str(mblp_dat_s), "--device", "cpu", "--jsonfile",
                    str(out)])
    assert "sdp nBlks = 3, lp Cols = 120" in capsys.readouterr().out
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    assert res.pinf_l1 <= 1e-5 and res.gap <= 5e-5 and res.dinf_l1 <= 5e-5
    assert len(res.final_ranks) == len(res.U) == len(res.V) == 3
    assert res.ulp.shape == res.vlp.shape == (120,)
    # bounded below by 0: every C_k is positive definite, every LP cost > 0
    assert res.pobj > 0.0
    payload = json.loads(out.read_text())
    assert set(payload) == {"problem_id", "file_path", "metrics",
                            "trajectory"}
    assert payload["problem_id"] == "mblp"
    assert payload["metrics"]["primal_obj"] == pytest.approx(res.pobj)
    p1 = payload["trajectory"]["phase_1"]
    # the trajectory carries the summed rank of the blocks, as the JAX one
    assert p1["curr_rank"][-1] == sum(res.final_ranks)
    assert len(p1["curr_rank"]) == len(p1["oracle_rank"]) > 0


def test_cli_solves_theta_on_cpu(theta_dat_s):
    """A dense objective through the CLI: Lovasz theta of a 30-vertex graph
    (the optimum of max <J, X> is at least 1, the solver minimizes -J)."""
    res = cli.main([str(theta_dat_s), "--device", "cpu"])
    assert res.status in (SolverStatus.PRIMAL_DUAL_OPTIMAL,
                          SolverStatus.PRIMAL_OPTIMAL)
    assert res.pinf_l1 <= 1e-5 and res.gap <= 5e-5 and res.dinf_l1 <= 5e-5
    assert res.pobj <= -1.0 and res.ulp is None


def test_cli_flags_are_the_jax_flags_plus_device():
    ours = {a.dest for a in cli.build_arg_parser()._actions}
    theirs = {a.dest for a in jax_cli.build_arg_parser()._actions}
    assert ours == theirs | {"device"}
    args = ["x.dat-s", "--phase1Tol", "1e+1", "--heuristicFactor", "100",
            "--rankSchedule", "4,6,9", "--disableOracle"]
    ours = cli.params_from_args(cli.build_arg_parser().parse_args(args))
    theirs = jax_cli.params_from_args(
        jax_cli.build_arg_parser().parse_args(args))
    assert ours.phase1_tol == theirs.phase1_tol == 10.0
    assert ours.heuristic_factor == theirs.heuristic_factor == 100.0
    assert list(ours.rank_schedule) == list(theirs.rank_schedule)
    assert ours.disable_oracle and theirs.disable_oracle


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(dat_s, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(dat_s)])


def test_cli_float32_is_a_later_slice(dat_s):
    """float32 was a later slice of the port and is ported now: the CLI
    solves in float32 and certifies (the parity with the JAX package's
    float32 solve is held in ``test_torch_float32.py``)."""
    res = cli.main([str(dat_s), "--device", "cpu", "--dtype", "float32"])
    assert res.status.value == "primal_dual_optimal"
    assert res.pinf_l1 <= 1e-5 and res.gap <= 5e-5


def test_delaunay_adjacency_is_a_planar_triangulation():
    A = delaunay_maxcut_adjacency(500, seed=14)
    assert A.shape == (500, 500)
    assert (A != A.T).nnz == 0
    assert A.diagonal().sum() == 0
    assert set(np.unique(A.data)) == {1.0}
    n_edges = A.nnz // 2
    # a triangulation of n points has at most 3n - 6 edges, and a random
    # one comes close to it
    assert 2.8 * 500 < n_edges <= 3 * 500 - 6
    B = delaunay_maxcut_adjacency(500, seed=14)
    assert (A != B).nnz == 0
