"""The port's entry points take the reference's spellings.

* ``infer`` and ``benchmark`` take ``--cpu`` (the root scripts' flag) as
  ``--device cpu``: with no GPU visible they run on the CPU with it and
  refuse to start without a device flag;
* ``from ltr_lowrank_sdp_torch import SolverParams, SDPProblem``, the two
  exports of ``ltr_lowrank_sdp_tpu/__init__.py``, import no JAX.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from ltr_lowrank_sdp_torch import benchmark, infer
from ltr_lowrank_sdp_torch.testing import theta_sdpa, write_sdpa

ROOT = pathlib.Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "runs" / "r5_theta")
DATASET = str(ROOT / "dataset")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_infer_takes_cpu(no_gpu, one_thread, tmp_path):
    common = ["-c", CKPT, "-i", "maxcut_n200_d4", "--root", DATASET]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(common)
    a, b = tmp_path / "cpu.json", tmp_path / "device.json"
    assert infer.main([*common, "--cpu", "--output", str(a)]) == 0
    assert infer.main([*common, "--device", "cpu", "--output", str(b)]) == 0
    assert json.loads(a.read_text()) == json.loads(b.read_text())


def test_benchmark_takes_cpu(no_gpu, one_thread, tmp_path):
    path = tmp_path / "hansmittel" / "theta12_gen.dat-s"
    path.parent.mkdir()
    write_sdpa(path, theta_sdpa(12, 3, 12))
    args = ["--instances", str(tmp_path), "--subtypes", "hansmittel",
            "--output-dir", str(tmp_path / "out"), "--fixed-rank", "3"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(args)
    assert benchmark.main([*args, "--cpu"]) == 0
    row = json.loads((tmp_path / "out" / "results.json").read_text())[
        "theta12_gen"]
    for side in ("default", "schedule"):
        assert row[side]["status"] in ("primal_dual_optimal",
                                       "primal_optimal")


def test_package_exports_the_solver_types_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['ltr_lowrank_sdp_tpu'] = None\n"
            "from ltr_lowrank_sdp_torch import SolverParams, SDPProblem\n"
            "from ltr_lowrank_sdp_torch import config, problem\n"
            "assert SolverParams is config.SolverParams\n"
            "assert SDPProblem is problem.SDPProblem\n"
            "assert SolverParams(dtype='float32').dtype == 'float32'\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
