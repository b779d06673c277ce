"""The port's instance generator and harvester against the repository's
``scripts/gen_instances.py`` and ``scripts/harvest.py`` (the JAX package),
on the CPU.

The generator's files are byte-identical.  One harvest of a MaxCut, a
matrix-completion and a theta file on each side, the port's solves started
from the JAX package's own starting factors and Lanczos vectors (mapped to
the problem's order, as ``test_torch_solver.py`` does; the two packages
draw them from different generators), gives the same label files: the same
keys, the same rank trajectories on MaxCut and matrix completion, and the
same graph features.  Theta's final oracle rank agrees within one, as
``dataset/README.md``'s spot check allows (a count of eigenvalues above
``eps * lambda_max`` flips near the threshold, and theta's counts part
under rounding: ``ROADMAP.md`` Queue 3).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.scripts import gen_instances, harvest
from ltr_lowrank_sdp_torch.solver import driver

ROOT = pathlib.Path(__file__).resolve().parent.parent
INSTANCES = {
    "maxcut_n200_d4": ["maxcut", "--n", "200", "--avg-degree", "4"],
    "MC_60x60_r2": ["matcomp", "--n1", "60", "--n2", "60", "--rank", "2"],
    "theta_n40_d10": ["theta", "--n", "40", "--avg-degree", "10"],
}


def _root_script(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["maxcut", "--n", "150", "--avg-degree", "5", "--seed", "3"],
    ["theta", "--n", "25", "--avg-degree", "6", "--seed", "4"],
    ["matcomp", "--n1", "30", "--n2", "40", "--rank", "2",
     "--sample-factor", "1.5", "--seed", "5"],
], ids=lambda a: a[0])
def test_generator_files_are_byte_identical(tmp_path, argv):
    root_gen = _root_script("gen_instances")
    a, b = tmp_path / "root.dat-s", tmp_path / "port.dat-s"
    assert root_gen.main([*argv, "--out", str(a)]) == 0
    assert gen_instances.main([*argv, "--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()


def _fields(p):
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(p).items()}


@pytest.mark.parametrize("name,n", [
    ("G11", 800), ("g22", 2000), ("maxcut_n200_d4", 200),
    ("maxcut_n3200_d14", 3200), ("mcp500-1", 500), ("p2p-Gnutella", 6301),
    ("delaunay_n14", 16384), ("delaunay_n20", 1048576), ("rgg_n_2_15", 32768),
    ("vsp_data", 40000), ("cs4", 22499), ("cit-HepPh", 34546),
    ("fe_4elt2", 11143), ("amazon0302", 262111), ("torus8a", 512),
    ("MC_100x100_r2", 200), ("MC_500", 1000), ("mc_1000x1000", 2000),
    ("MC_10000", 20000), ("MC_x", 100), ("shmup4_mb", 800),
    ("randommc", 400), ("theta_n300_d75", 300), ("hamming_9_8", 512),
])
def test_family_params_match_the_root_script(name, n):
    root_harvest = _root_script("harvest")
    assert _fields(harvest.family_params(name, n, 123.0)) == _fields(
        root_harvest.family_params(name, n, 123.0))


def _jax_start(path, jparams):
    """The JAX package's starting factors and Lanczos start vectors of a
    solve of ``path``, in the problem's row order."""
    import jax
    import jax.numpy as jnp

    from ltr_lowrank_sdp_tpu.problem import load_problem as jax_load
    from ltr_lowrank_sdp_tpu.solver.common import init_factors
    from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
    from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state

    jprob = jax_load(str(path))
    cones = JaxSolver(jprob, jparams).cones
    R0, _ = init_factors(make_rank_state(jprob, jparams).ranks,
                         jprob.block_dims, jprob.n_lp_cols,
                         jax.random.PRNGKey(jparams.seed), jnp.float64)
    key7 = jax.random.PRNGKey(7)
    return ([ops.permute_rows_out(np.asarray(r))
             for ops, r in zip(cones, R0)],
            [ops.permute_rows_out(np.asarray(jax.random.normal(
                jax.random.fold_in(key7, i), (ops.n,), jnp.float64)))
             for i, ops in enumerate(cones)])


@pytest.fixture(scope="module")
def harvested(tmp_path_factory):
    """The three instances harvested by the root script (JAX on the CPU, a
    subprocess) and by the port (``--device cpu``, one torch thread, each
    solve started from the JAX package's starting point)."""
    tmp = tmp_path_factory.mktemp("harvest")
    inst = tmp / "inst"
    inst.mkdir()
    for name, argv in INSTANCES.items():
        gen_instances.main([*argv, "--out", str(inst / f"{name}.dat-s")])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    jax_run = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "harvest.py"), "--instances",
         str(inst), "--root", str(tmp / "jax")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    assert "FAILED" not in jax_run.stdout, jax_run.stdout
    root_harvest = _root_script("harvest")

    def solve_from_jax_start(prob, params, logger=None, json_path=None,
                             device=None):
        path = logger.file_path
        R0, v0 = _jax_start(path, root_harvest.family_params(
            logger.problem_name, max(prob.block_dims), params.time_sec_limit))
        return driver.Solver(prob, params, device=device).solve(
            logger=logger, json_path=json_path, init_factors=R0,
            lanczos_start=v0)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(driver, "solve", solve_from_jax_start)
            rows = harvest.harvest(harvest.build_argparser().parse_args(
                ["--instances", str(inst), "--root", str(tmp / "port")]),
                torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    return tmp, rows


def _label(root, name):
    with open(root / "sol_json" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_harvest_labels_match_the_root_script(harvested, name):
    tmp, rows = harvested
    row = {r["name"]: r for r in rows}[name]
    assert row["status"] == "primal_dual_optimal"
    assert all(row[k] is not None for k in ("parse_s", "solve_s",
                                            "process_s"))
    got, want = _label(tmp / "port", name), _label(tmp / "jax", name)
    assert got.keys() == want.keys()
    assert got["metrics"].keys() == want["metrics"].keys()
    assert got["problem_id"] == want["problem_id"] == name
    for phase in ("phase_1", "phase_2"):
        assert got["trajectory"][phase].keys() == want["trajectory"][
            phase].keys()
    assert (tmp / "port" / "logs" / f"{name}.log").stat().st_size > 0
    if name.startswith("theta"):
        final = [d["metrics"]["oracle_rank"] for d in (got, want)]
        assert abs(final[0] - final[1]) <= 1, final
    else:
        assert got["trajectory"] == want["trajectory"]
        assert got["metrics"]["oracle_rank"] == want["metrics"]["oracle_rank"]
    np.testing.assert_allclose(got["metrics"]["primal_obj"],
                               want["metrics"]["primal_obj"], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_harvest_graph_features_match_the_root_script(harvested, name):
    tmp = harvested[0]
    with np.load(tmp / "port" / "proc" / f"{name}.npz") as got, \
            np.load(tmp / "jax" / "proc" / f"{name}.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_harvest_skips_existing_outputs_unless_overwrite(tmp_path):
    inst = tmp_path / "inst"
    inst.mkdir()
    gen_instances.main(["maxcut", "--n", "60", "--avg-degree", "4",
                        "--out", str(inst / "maxcut_n60_d4.dat-s")])
    argv = ["--instances", str(inst), "--root", str(tmp_path / "out"),
            "--device", "cpu"]
    outs = [tmp_path / "out" / sub / f"maxcut_n60_d4.{ext}"
            for sub, ext in (("sol_json", "json"), ("proc", "npz"))]

    def stamps():
        return [p.stat().st_mtime_ns for p in outs]

    assert harvest.main(argv) == 0
    first, label = stamps(), outs[0].read_text()
    os.utime(outs[0], ns=(1, 1))
    os.utime(outs[1], ns=(1, 1))
    (row,) = harvest.harvest(harvest.build_argparser().parse_args(argv),
                             torch.device("cpu"))
    assert row == {"name": "maxcut_n60_d4", "status": None, "parse_s": None,
                   "solve_s": None, "process_s": None}
    assert stamps() == [1, 1]
    (row,) = harvest.harvest(harvest.build_argparser().parse_args(
        [*argv, "--overwrite", "--skip-parse"]), torch.device("cpu"))
    assert row["status"] == "primal_dual_optimal" and row["process_s"] is None
    assert stamps()[0] > 1 and stamps()[1] == 1
    assert json.loads(outs[0].read_text())["trajectory"] == json.loads(
        label)["trajectory"]
    assert first[0] > 1
