"""The port's serving entry points on the CPU: ``ltr_lowrank_sdp_torch.infer``
against the repository's root ``infer.py`` on one dataset graph and on a
generated ``.dat-s`` file, and ``ltr_lowrank_sdp_torch.benchmark`` (predict,
then a default and a scheduled solve) writing the root ``benchmark.py``'s
files and schemas on a tiny generated instance, with the schedule that the
root benchmark's ``predict_schedule`` gives."""

import importlib.util
import json
import pathlib

import pytest
import torch

from ltr_lowrank_sdp_torch import benchmark, infer
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.testing import theta_sdpa, write_sdpa

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "runs" / "r5_theta")
DATASET = str(ROOT / "dataset")


def _root_module(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's OpenMP workers spin after each parallel op and starve XLA's
    CPU threads in the same process; the sizes here need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_theta(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    path = d / "hansmittel" / "theta16_gen.dat-s"
    path.parent.mkdir()
    write_sdpa(path, theta_sdpa(16, 4, 16))
    return d, path


def _printed(capsys):
    return [line for line in capsys.readouterr().out.splitlines()
            if line.startswith(("predicted schedule", ">>>", "ground truth",
                                "  "))]


@pytest.mark.parametrize("which", ["dataset-graph", "dat-s"])
def test_infer_matches_the_root_cli(which, tiny_theta, tmp_path, capsys):
    inp = ("maxcut_n200_d4" if which == "dataset-graph"
           else str(tiny_theta[1]))
    ref_out, out = tmp_path / "ref.json", tmp_path / "ours.json"
    common = ["-c", CKPT, "-i", inp, "--root", DATASET]
    assert _root_module("infer").main(
        [*common, "--cpu", "--output", str(ref_out)]) == 0
    want = _printed(capsys)
    K.reset_counts()
    assert infer.main([*common, "--device", "cpu",
                       "--output", str(out)]) == 0
    assert _printed(capsys) == want
    assert json.loads(out.read_text()) == json.loads(ref_out.read_text())
    assert K.counts()["gatv2_softmax_agg"] == (0, 3)
    assert K.counts()["graph_pool"] == (0, 1)


def test_benchmark_writes_the_root_schema(tiny_theta, capsys):
    inst_dir, path = tiny_theta
    out = inst_dir / "results"
    assert benchmark.main([
        "--checkpoint", CKPT, "--instances", str(inst_dir), "--root",
        DATASET, "--subtypes", "hansmittel", "--output-dir", str(out),
        "--device", "cpu"]) == 0
    assert "speedup" in capsys.readouterr().out
    name = "theta16_gen"
    sched = json.loads((out / f"{name}_r_sched.json").read_text())
    assert set(sched) == {"rank_schedule", "schedule_length"}
    want, L = _root_module("benchmark").predict_schedule(CKPT, str(path),
                                                         DATASET)
    assert sched == {"rank_schedule": want, "schedule_length": L}
    results = json.loads((out / "results.json").read_text())
    assert set(results) == {name}
    row = results[name]
    assert set(row) == {"name", "subtype", "n", "default", "schedule",
                        "speedup", "obj_rel_diff"}
    assert (row["name"], row["subtype"], row["n"]) == (name, "hansmittel", 16)
    for side in ("default", "schedule"):
        assert set(row[side]) == {"solve_time_sec", "primal_obj", "gap",
                                  "pinf_l1", "dinf_l1", "status"}
        assert row[side]["status"] in ("primal_dual_optimal",
                                       "primal_optimal")
        traj = json.loads((out / f"{name}_"
                           f"{'default' if side == 'default' else 'sched'}"
                           ".json").read_text())
        assert set(traj) == {"problem_id", "file_path", "metrics",
                             "trajectory"}
    assert row["speedup"] == pytest.approx(
        row["default"]["solve_time_sec"] / row["schedule"]["solve_time_sec"])
    # --merge keeps rows that a run does not cover; --only / --skip filter
    assert benchmark.main([
        "--instances", str(inst_dir), "--subtypes", "hansmittel",
        "--output-dir", str(out), "--device", "cpu", "--merge",
        "--skip", name]) == 0
    assert set(json.loads((out / "results.json").read_text())) == {name}
