"""The port's training entry point against the root ``train.py``, on the CPU.

Both start ``--init-from`` the same small checkpoint written by the JAX
package (1 GATv2 layer x 2 heads, hidden 16), with dropout 0 and teacher
forcing 1 (so neither draws a random number), and train 2 epochs on a
dataset of the twelve smallest labelled graphs (10 train, 1 val, 1 test).
The cosine schedule without warmup makes both epochs' updates real.  The
per-epoch ``train_loss`` and ``val_log_mae`` agree to 1e-4 relative (float32
on both sides, two AdamW updates apart), the five output files have the same
keys, and each side's ``model.msgpack`` loads in the other package.
"""

import json
import os
import pathlib

import numpy as np
import jax
import pytest
import torch

import train as root_train
from ltr_lowrank_sdp_tpu.models import checkpoint as jax_ckpt
from ltr_lowrank_sdp_tpu.models import net as jax_net
from ltr_lowrank_sdp_torch import train
from ltr_lowrank_sdp_torch.models import checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
WIDTH = dict(hidden_dim=16, edge_dim=8, global_dim=8, num_gnn_layers=1,
             num_heads=2, decoder_hidden_dim=16, decoder_num_layers=1,
             max_seq_len=16, dropout=0.0)
FILES = ("model.msgpack", "config.json", "eval_report.txt",
         "eval_predictions.json", "training_log.json")


def _flags(cfg):
    return [f"--{k.replace('_', '-')}={v}" for k, v in cfg.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    # a dataset of the twelve smallest labelled graphs
    src = ROOT / "dataset"
    labelled = [p.stem for p in (src / "sol_json").glob("*.json")
                if (src / "proc" / f"{p.stem}.npz").exists()]
    sizes = {name: np.load(src / "proc" / f"{name}.npz")["x"].shape[0]
             for name in labelled}
    root = tmp / "dataset"
    for sub in ("proc", "sol_json"):
        (root / sub).mkdir(parents=True)
    for name in sorted(labelled, key=lambda n: (sizes[n], n))[:12]:
        os.symlink(src / "proc" / f"{name}.npz",
                   root / "proc" / f"{name}.npz")
        os.symlink(src / "sol_json" / f"{name}.json",
                   root / "sol_json" / f"{name}.json")
    # the shared starting point, written by the JAX package
    cfg = jax_net.ModelConfig(**WIDTH)
    model = jax_net.RankSchedulePredictor(cfg)
    z = np.zeros
    params = model.init({"params": jax.random.PRNGKey(3),
                         "dropout": jax.random.PRNGKey(4)},
                        z((4, 16), np.float32), z((2, 6), np.int32),
                        z((6, 5), np.float32), z((4,), np.int32),
                        z((1, 17), np.float32), 1)
    params = jax.tree.map(lambda p: p + 0.05 if p.ndim == 1 else p, params)
    jax_ckpt.save_checkpoint(str(tmp / "init"), params, cfg)
    common = ["--root", str(root), "--init-from", str(tmp / "init"),
              "--epochs", "2", "--warmup-epochs", "0", "--tf-start", "1",
              "--tf-end", "1", "--batch-size", "16", *_flags(WIDTH)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert root_train.main([*common, "--output-dir",
                                str(tmp / "jax")]) == 0
        assert train.main([*common, "--output-dir", str(tmp / "port"),
                           "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    return tmp


def _log(path):
    with open(path / "training_log.json") as f:
        return json.load(f)


def test_epochs_match_root_train(runs):
    want, got = _log(runs / "jax"), _log(runs / "port")
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert set(g) == set(w)
        assert g["tf_ratio"] == w["tf_ratio"] == 1.0
        for k in ("train_loss", "val_log_mae", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert want["history"][0]["train_loss"] != want["history"][1][
        "train_loss"]                       # the updates moved the model
    np.testing.assert_allclose(got["best_val_log_mae"],
                               want["best_val_log_mae"], rtol=1e-4)
    assert set(got["test"]) == set(want["test"])
    assert set(got["params"]) == set(want["params"]) | {"device"}


def test_output_files_match_root_train(runs):
    for name in FILES:
        assert (runs / "port" / name).exists(), name
        assert (runs / "jax" / name).exists(), name
    with open(runs / "port" / "config.json") as f:
        got = json.load(f)
    with open(runs / "jax" / "config.json") as f:
        want = json.load(f)
    assert got["model_config"] == want["model_config"]
    assert got["epoch"] == want["epoch"]
    with open(runs / "port" / "eval_predictions.json") as f:
        got = json.load(f)
    with open(runs / "jax" / "eval_predictions.json") as f:
        want = json.load(f)
    assert got.keys() == want.keys()
    assert got["targets"] == want["targets"]
    assert got["names"] == want["names"]


def test_checkpoints_load_in_both_packages(runs):
    """The port's checkpoint loads in the JAX package's load_model with the
    same parameters as its own loader reads, and the JAX package's in the
    port's."""
    _, jparams, cfg = jax_ckpt.load_model(str(runs / "port"))
    assert cfg.to_dict() == jax_net.ModelConfig(**WIDTH).to_dict()
    model, _ = checkpoint.load_model(str(runs / "port"), device="cpu")
    from_jax = checkpoint.params_from_flax(jax.tree.map(np.asarray, jparams))
    for k, v in model.state_dict().items():
        assert torch.equal(v, from_jax[k]), k
    checkpoint.load_model(str(runs / "jax"), device="cpu")
