"""The port's CLI and readers on the CPU: a generated SDPA ``.dat-s`` and a
SuiteSparse-style ``.mat`` MaxCut file are read into the same
``SDPProblem`` as the JAX package reads, solved through
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
from ltr_lowrank_sdp_torch.testing import delaunay_maxcut_adjacency

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


@pytest.mark.parametrize("which", ["dat_s", "mat"])
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
    with pytest.raises(NotImplementedError, match="later slice"):
        cli.main([str(dat_s), "--device", "cpu", "--dtype", "float32"])


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
