"""The port's ``predict_all`` on the CPU writes the committed rank schedules.

``benchmark/r_sched/*.json`` were written by the repository's
``scripts/predict_all.py`` (the JAX package) from ``runs/r5`` and the
cached ``dataset/proc`` graphs.  The port's twin, run into a temporary
directory, writes the same ``rank_schedule`` and ``schedule_length`` for all
ten, and the same artifact keys.
"""

import json
import pathlib

import torch

from ltr_lowrank_sdp_torch.scripts import predict_all

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_predict_all_writes_the_committed_schedules(tmp_path):
    committed = sorted((ROOT / "benchmark" / "r_sched").glob("*.json"))
    assert len(committed) == 10
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert predict_all.main([
            "-c", str(ROOT / "runs" / "r5"), "--instances",
            str(ROOT / "benchmark" / "instances"), "--root",
            str(ROOT / "dataset"), "--out", str(tmp_path),
            "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        p.name for p in committed]
    for path in committed:
        want = json.loads(path.read_text())
        got = json.loads((tmp_path / path.name).read_text())
        assert got.keys() == want.keys()
        assert got["name"] == want["name"] == path.stem
        assert got["rank_schedule"] == want["rank_schedule"], path.stem
        assert got["schedule_length"] == want["schedule_length"], path.stem
