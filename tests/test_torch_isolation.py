"""The port stands alone: it imports neither JAX nor the JAX package, runs
on the GPU unless asked for the CPU, and takes its kernels' plain versions
only for tensors on the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch import benchmark, infer, resolve_device, train
from ltr_lowrank_sdp_torch.models.checkpoint import load_model
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ltr_lowrank_sdp_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "msgpack",
             "ltr_lowrank_sdp_tpu")


def _port_modules():
    return sorted(p for p in PORT.rglob("*.py") if "build" not in p.parts)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            yield "__import__"


@pytest.mark.parametrize(
    "path", _port_modules() + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)
    assert "__import__" not in roots


def test_port_imports_with_jax_blocked():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in _port_modules()]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n"
            + "".join(f"sys.modules[{name!r}] = None\n" for name in FORBIDDEN)
            + "".join(f"import {m}\n" for m in mods)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = random_maxcut_problem(80, avg_degree=4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solver(prob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert Solver(prob, device="cpu").device == torch.device("cpu")
    ckpt = str(ROOT / "runs" / "r5_theta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(ckpt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["-c", ckpt, "-i", "maxcut_n200_d4",
                    "--root", str(ROOT / "dataset")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--checkpoint", ckpt, "--instances",
                        str(tmp_path), "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--root", str(ROOT / "dataset"), "--epochs", "1",
                    "--output-dir", str(tmp_path / "run")])
    assert not any(tmp_path.iterdir())     # nothing written, nothing solved


def test_label_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                          tmp_path):
    from ltr_lowrank_sdp_torch import tune
    from ltr_lowrank_sdp_torch.scripts import harvest, predict_all

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "inst").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harvest.main(["--instances", str(tmp_path / "inst"), "--root",
                      str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_all.main(["-c", str(ROOT / "runs" / "r5"), "--instances",
                          str(ROOT / "benchmark" / "instances"), "--root",
                          str(ROOT / "dataset"), "--out",
                          str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--root", str(ROOT / "dataset"), "--output-dir",
                   str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()     # nothing written
    # --cpu is --device cpu
    assert harvest.main(["--instances", str(tmp_path / "inst"), "--root",
                         str(tmp_path / "cpu"), "--cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "cpu").iterdir()) == [
        "logs", "proc", "sol_json"]


def test_hallar_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch,
                                                            tmp_path):
    from ltr_lowrank_sdp_torch.hallar import cli as hcli
    from ltr_lowrank_sdp_torch.hallar import solver as hsolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = hsolver.build_mss_problem([(0, 1), (1, 2), (2, 0)], 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hsolver.hallar_solve(prob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hcli.main(["--run_tests"])
    out = tmp_path / "o.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hcli.main(["-i", str(tmp_path / "p.hslr"), "-o", str(out)])
    assert not out.exists()
    K.reset_counts()
    res = hsolver.hallar_solve(prob, hsolver.HallarParams(
        maxiter_hallar=1, maxiter_fista=5), device="cpu")
    assert res.iters == 1 and res.host_reads > 0
    assert all(launches == 0 for launches, _ in K.counts().values())
    assert {k for k, (_, plain) in K.counts().items() if plain} == {
        "coo_contract_segsum", "sym_contract_sum", "spmm_constr_csr"}


def test_cpu_solve_runs_the_plain_versions_only():
    K.reset_counts()
    prob = random_maxcut_problem(60, avg_degree=4, seed=2)
    res = Solver(prob, device="cpu").solve()
    counts = K.counts()
    maxcut = {"spmm_sym_csr", "diag_rowdot", "diag_normal_matvec",
              "sym_contract_sum"}
    assert set(counts) == maxcut | {"coo_contract_segsum", "spmm_constr_csr",
                                    "lp_constr_segsum", "lp_col_wsum",
                                    "gatv2_softmax_agg", "graph_pool",
                                    "gatv2_softmax_agg_bwd",
                                    "graph_pool_bwd", "gather_rowsum"}
    assert all(launches == 0 for launches, _ in counts.values()), counts
    # the MaxCut family runs K1-K4 and never the general-cone or LP kernels
    assert all((plain > 0) == (name in maxcut)
               for name, (_, plain) in counts.items()), counts
    assert res.host_syncs > 0


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(K.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_kernels()


def test_plain_versions_match_dense_references():
    rng = np.random.default_rng(0)
    n, r = 40, 5
    # symmetric sparse C from an upper-triangle COO with a diagonal
    rows = np.concatenate([np.arange(n), rng.integers(0, n, 60)])
    cols = np.concatenate([np.arange(n), rng.integers(0, n, 60)])
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    key = np.unique(lo * n + hi)
    lo, hi = key // n, key % n
    vals = rng.standard_normal(lo.size)
    C = np.zeros((n, n))
    C[lo, hi] = vals
    C[hi, lo] = vals
    csr = K.SymCSR.from_upper_coo(lo, hi, vals, n, "cpu")
    assert csr.nnz == 2 * lo.size - int(np.sum(lo == hi))
    Y = rng.standard_normal((n, r))
    d = rng.standard_normal(n)
    Yt, dt = torch.tensor(Y), torch.tensor(d)
    np.testing.assert_allclose(
        K.spmm_sym_csr(csr, Yt, 1.5, dt).numpy(),
        1.5 * C @ Y + d[:, None] * Y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(K.spmm_sym_csr(None, Yt, 0.0, dt).numpy(),
                               d[:, None] * Y, rtol=1e-12, atol=1e-12)
    U, V = rng.standard_normal((n, r)), rng.standard_normal((n, r))
    Ut, Vt = torch.tensor(U), torch.tensor(V)
    o1, o2 = K.diag_rowdot(Ut, Vt, dt, 2.0, second=True)
    np.testing.assert_allclose(o1.numpy(), 2 * d * np.sum(U * V, 1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(o2.numpy(), d * np.sum(V * V, 1),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        K.diag_normal_matvec(Ut, Vt, dt).numpy(),
        U + (d * d * np.sum(U * V, 1))[:, None] * V, rtol=1e-12, atol=1e-12)
    coef = np.where(lo != hi, 2.0 * vals, vals)
    X = 0.5 * (U @ V.T + V @ U.T)
    got = K.sym_contract_sum(torch.tensor(lo, dtype=torch.int32),
                             torch.tensor(hi, dtype=torch.int32),
                             torch.tensor(coef), Ut, Vt)
    assert float(got) == pytest.approx(np.sum(C * X), rel=1e-12)
    got = K.sym_contract_sum(torch.tensor(lo, dtype=torch.int32),
                             torch.tensor(hi, dtype=torch.int32),
                             torch.tensor(coef), Ut, Ut)
    assert float(got) == pytest.approx(np.sum(C * (U @ U.T)), rel=1e-12)


def test_cpu_training_step_runs_the_plain_versions_only():
    """One training step of a small predictor on a collated dataset batch,
    with dropout: every GATv2 layer's forward and backward and the poolings'
    go through the plain versions of K9 / K11 and K10 / K12."""
    from ltr_lowrank_sdp_torch.data.loader import create_splits, iterate_batches
    from ltr_lowrank_sdp_torch.models.loss import LossWeights
    from ltr_lowrank_sdp_torch.models.net import (ModelConfig,
                                                  RankSchedulePredictor,
                                                  init_params)
    from ltr_lowrank_sdp_torch.optim import TrainOptimizer

    ds, train_idx, _, _ = create_splits(str(ROOT / "dataset"), seed=42)
    small = [i for i in train_idx if ds.samples[i][0].startswith(
        "maxcut_n200")]
    batch = next(iterate_batches(ds, small, 4))
    model = RankSchedulePredictor(ModelConfig(
        hidden_dim=16, edge_dim=8, global_dim=8, num_gnn_layers=2,
        num_heads=2, decoder_hidden_dim=16, dropout=0.15))
    init_params(model, torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in model.parameters()]
    opt = TrainOptimizer(model.parameters(), 1e-3, 1e-4, 1.0)
    K.reset_counts()
    loss = train.train_step(model, opt, batch, LossWeights(), 0.5,
                            torch.Generator().manual_seed(1), "cpu")
    counts = K.counts()
    assert bool(torch.isfinite(loss))
    assert all(launches == 0 for launches, _ in counts.values()), counts
    assert counts["gatv2_softmax_agg"][1] == counts[
        "gatv2_softmax_agg_bwd"][1] == 2
    assert counts["graph_pool"][1] == counts["graph_pool_bwd"][1] == 1
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
