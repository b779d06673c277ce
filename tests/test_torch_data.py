"""The port's data pipeline against the JAX package's: the SDPA -> graph
feature processor (``data/processor.py``) on generated instances that take
each of its three edge paths, and the inference half of the loader
(``data/loader.py``: labels, the seeded split) on the repository's
``dataset/``.

The processor is numpy / scipy on both sides, so its arrays must be
identical, not merely close.
"""

import json
import pathlib

import numpy as np
import pytest

from ltr_lowrank_sdp_tpu.data import loader as jax_loader
from ltr_lowrank_sdp_tpu.data import processor as jax_processor
from ltr_lowrank_sdp_torch.data import loader, processor
from ltr_lowrank_sdp_torch.testing import (matcomp_sdpa, multiblock_lp_sdpa,
                                           theta_sdpa, write_sdpa)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATASET = ROOT / "dataset"
GRAPH_KEYS = ("x", "edge_index", "edge_attr", "global_attr", "num_nodes")


def _write_maxcut(path, n, seed):
    """A MaxCut SDP: one diagonal constraint per row, so no two constraints
    overlap and the processor falls back to k-NN edges."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    keep = u < v
    edges = sorted(set(zip(u[keep].tolist(), v[keep].tolist())))
    lines = ["* generated MaxCut instance", str(n), "1", str(n),
             " ".join(["1"] * n)]
    lines += [f"0 1 {a + 1} {b + 1} -0.25" for a, b in edges]
    lines += [f"0 1 {i + 1} {i + 1} 1.0" for i in range(n)]
    lines += [f"{i + 1} 1 {i + 1} {i + 1} 1.0" for i in range(n)]
    path.write_text("\n".join(lines) + "\n")


INSTANCES = {
    # name: (writer, the edge path it takes)
    "theta40": (lambda p: write_sdpa(p, theta_sdpa(40, 10, 40)), "full"),
    "matcomp70": (lambda p: write_sdpa(p, matcomp_sdpa(30, 40, 2, 2.0, 1)),
                  "sparse"),
    "multiblock_lp": (lambda p: write_sdpa(p, multiblock_lp_sdpa()), "full"),
    "maxcut60": (lambda p: _write_maxcut(p, 60, 5), "knn"),
}


@pytest.fixture(scope="module", params=sorted(INSTANCES))
def instance(request, tmp_path_factory):
    writer, path_kind = INSTANCES[request.param]
    path = tmp_path_factory.mktemp("proc") / f"{request.param}.dat-s"
    writer(path)
    return str(path), path_kind


def test_processor_arrays_are_identical(instance, tmp_path):
    path, path_kind = instance
    want = jax_processor.process_sdpa_to_graph(path, None)
    out = tmp_path / "g.npz"
    got = processor.process_sdpa_to_graph(path, str(out))
    for key in GRAPH_KEYS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with np.load(out) as z:
        assert sorted(z.files) == sorted(GRAPH_KEYS)
        for key in GRAPH_KEYS:
            np.testing.assert_array_equal(z[key], want[key], err_msg=key)
    # the instance takes the edge path it was chosen for
    m = int(got["num_nodes"])
    assert got["edge_index"].shape[1] > 0
    if path_kind == "knn":
        C, A, b, m, n, offsets = processor._parse_for_features(path)
        ex = processor.FeatureExtractor(C, A, b, m, n, offsets)
        assert ex._edges_full(0.05)[0].shape[1] == 0
        np.testing.assert_array_equal(ex._knn_fallback(15)[0],
                                      got["edge_index"])
    else:
        assert (m >= 1000) == (path_kind == "sparse")


def test_processor_drops_the_lp_block(tmp_path):
    path = tmp_path / "mblp.dat-s"
    data = multiblock_lp_sdpa()
    write_sdpa(path, data)
    C, A, b, m, n, offsets = processor._parse_for_features(str(path))
    assert n == sum(data.block_dims) and offsets[-1] == n
    assert m == data.n_constrs and len(A) == m


def test_create_splits_match():
    ours = loader.create_splits(str(DATASET), seed=42)
    ref = jax_loader.create_splits(str(DATASET), seed=42)
    assert ours[0].samples == ref[0].samples
    for a, b in zip(ours[1:], ref[1:]):
        assert a == b
    assert len(ours[3]) > 0
    names = loader.get_benchmark_names(str(ROOT / "benchmark"))
    assert names == jax_loader.get_benchmark_names(str(ROOT / "benchmark"))


def test_rank_schedule_labels_match():
    paths = sorted((DATASET / "sol_json").glob("*.json"))
    assert len(paths) > 50
    for p in paths:
        traj = json.loads(p.read_text()).get("trajectory", {})
        sched = loader.extract_rank_schedule(traj)
        assert sched == jax_loader.extract_rank_schedule(traj), p.name
        assert (loader.classify_schedule_type(sched)
                == jax_loader.classify_schedule_type(sched))
        assert (loader.pad_schedule(sched, 16)
                == jax_loader.pad_schedule(sched, 16))


def test_dataset_samples_match():
    ours = loader.SDPDataset(str(DATASET))
    ref = jax_loader.SDPDataset(str(DATASET))
    assert len(ours) == len(ref)
    for i in range(0, len(ours), 7):
        a, b = ours.get(i), ref.get(i)
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (a.name, a.length, a.schedule_type) == (
            b.name, b.length, b.schedule_type)
        for field in ("x", "edge_index", "edge_attr", "global_attr",
                      "schedule", "mask"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
