"""The port's ``tune`` against the repository's root ``tune.py`` (the JAX
package), on the CPU.

The search space builds the same model configurations and loss weights at
its corners, and the parameter-budget guard counts the same parameters.
One trial of ``objective`` (a stub trial in place of Optuna's, dropout 0,
one epoch on the twenty smallest labelled graphs, float64 on both sides)
starts from the JAX package's initial parameters, carried across with
``params_from_flax``, and draws the JAX package's teacher-forcing coins
(the port's model, batches, initialiser and step patched for it, as the
root objective's loader and initialiser are);
its best validation log-MAE agrees with the root ``objective``'s to 1e-6
relative.
"""

import argparse
import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tune as root_tune
from ltr_lowrank_sdp_tpu.data import loader as jax_loader
from ltr_lowrank_sdp_tpu.models import net as jax_net
from ltr_lowrank_sdp_torch import train, tune
from ltr_lowrank_sdp_torch.models import checkpoint
from ltr_lowrank_sdp_torch.models.net import (RankSchedulePredictor,
                                              count_parameters)
from ltr_lowrank_sdp_torch.testing import StubTrial

ROOT = pathlib.Path(__file__).resolve().parent.parent

LOW = dict(hidden_dim=32, num_heads=2, edge_dim=16, global_dim=16,
           num_gnn_layers=2, decoder_hidden_dim=48, decoder_num_layers=1,
           dropout=0.05, length_weight=0.2, mono_weight=0.0,
           initial_weight=0.1, final_weight=0.1, under_weight=1.5, lr=1e-4,
           weight_decay=1e-6, batch_size=8)
HIGH = dict(hidden_dim=96, num_heads=4, edge_dim=64, global_dim=64,
            num_gnn_layers=4, decoder_hidden_dim=128, decoder_num_layers=2,
            dropout=0.3, length_weight=1.0, mono_weight=0.3,
            initial_weight=0.5, final_weight=0.5, under_weight=5.0, lr=3e-3,
            weight_decay=1e-3, batch_size=32)
# hidden 80 over 4 heads, and 48 over 2 / 4: the rounding to the heads
MIXED = [dict(LOW, hidden_dim=80, num_heads=4, num_gnn_layers=3),
         dict(HIGH, hidden_dim=48, num_heads=2, decoder_num_layers=1),
         dict(LOW, hidden_dim=64, num_heads=4, decoder_hidden_dim=128)]
CORNERS = {"low": LOW, "high": HIGH, **{f"mixed{i}": c
                                        for i, c in enumerate(MIXED)}}


def _plain(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("corner", sorted(CORNERS))
def test_search_space_matches_the_root_script(corner):
    values = CORNERS[corner]
    assert _plain(tune.build_model_config(StubTrial(values))) == _plain(
        root_tune.build_model_config(StubTrial(values)))
    assert _plain(tune.build_loss_weights(StubTrial(values))) == _plain(
        root_tune.build_loss_weights(StubTrial(values)))


@pytest.mark.parametrize("corner", sorted(CORNERS))
def test_parameter_counts_match_the_root_script(corner):
    cfg = root_tune.build_model_config(StubTrial(CORNERS[corner]))
    z = np.zeros
    params = jax_net.RankSchedulePredictor(cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        z((4, 16), np.float32), z((2, 6), np.int32), z((6, 5), np.float32),
        z((4,), np.int32), z((1, 17), np.float32), 1)
    want = jax_net.count_parameters(params)
    model = RankSchedulePredictor(tune.build_model_config(
        StubTrial(CORNERS[corner])))
    assert count_parameters(model) == want
    if want > tune.PARAM_BUDGET:       # the high corner: a pruned trial
        for guard, arg in ((tune.count_and_guard, model),
                           (root_tune.count_and_guard, params)):
            with pytest.raises(ValueError, match="budget exceeded"):
                guard(arg)
    else:
        assert tune.count_and_guard(model) == root_tune.count_and_guard(
            params) == want
    with pytest.raises(ValueError, match="parameter budget exceeded"):
        tune.count_and_guard(model, budget=want - 1)
    with pytest.raises(ValueError, match="parameter budget exceeded"):
        root_tune.count_and_guard(params, budget=want - 1)


TRIAL = dict(LOW, dropout=0.0, lr=1e-3, weight_decay=1e-4,
             length_weight=0.5, mono_weight=0.1, initial_weight=0.25,
             final_weight=0.25, under_weight=3.0)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A dataset of the twenty smallest labelled graphs (18 train, 1 val,
    1 test)."""
    src = ROOT / "dataset"
    labelled = [p.stem for p in (src / "sol_json").glob("*.json")
                if (src / "proc" / f"{p.stem}.npz").exists()]
    sizes = {name: np.load(src / "proc" / f"{name}.npz")["x"].shape[0]
             for name in labelled}
    root = tmp_path_factory.mktemp("tune") / "dataset"
    for sub in ("proc", "sol_json"):
        (root / sub).mkdir(parents=True)
    for name in sorted(labelled, key=lambda n: (sizes[n], n))[:20]:
        os.symlink(src / "proc" / f"{name}.npz",
                   root / "proc" / f"{name}.npz")
        os.symlink(src / "sol_json" / f"{name}.json",
                   root / "sol_json" / f"{name}.json")
    return root


def test_objective_matches_the_root_script(small_root, monkeypatch):
    args = argparse.Namespace(root=str(small_root), seed=42,
                              epochs_per_trial=1, cpu=True, device=None)
    # the root objective in float64: its batches' real arrays and its
    # initial parameters cast up, the parameters kept for the port
    batches = jax_loader.iterate_batches

    def iterate_batches64(*a, **kw):
        for b in batches(*a, **kw):
            yield dataclasses.replace(b, **{
                k: np.asarray(getattr(b, k), np.float64) for k in (
                    "x", "edge_attr", "global_attr", "schedule", "mask")})

    init = jax_net.RankSchedulePredictor.init
    kept = []

    def init64(self, *a, **kw):
        params = jax.tree.map(lambda p: p.astype(jnp.float64),
                              init(self, *a, **kw))
        kept.append(params)
        return params

    monkeypatch.setattr(jax_loader, "iterate_batches", iterate_batches64)
    monkeypatch.setattr(jax_net.RankSchedulePredictor, "init", init64)
    jax_trial = StubTrial(TRIAL)
    want = root_tune.objective(jax_trial, args)

    # the port's objective in float64 from JAX's initial parameters, each
    # step given the coins the root objective's step drew (the step's key,
    # fold_in(rng, epoch * 1000 + nb), read back from its generator's seed)
    state = checkpoint.params_from_flax(jax.tree.map(np.asarray, kept[0]))
    tensors = train.batch_tensors

    def batch_tensors64(b, device):
        return {k: v.double() if v.is_floating_point() else v
                for k, v in tensors(b, device).items()}

    def init_from_jax(model, generator):
        model.load_state_dict(state)

    def step_with_coins(model, opt, b, lw, tf_ratio, generator, device):
        epoch, nb = divmod(generator.initial_seed() - (args.seed << 32),
                           tune.STEP_STRIDE)
        drng = jax.random.fold_in(jax.random.PRNGKey(args.seed),
                                  epoch * 1000 + nb)
        coins = torch.tensor(np.asarray(jax.vmap(
            lambda t: jax.random.uniform(jax.random.fold_in(drng, t)))(
            jnp.arange(16))), dtype=torch.float64)
        model.train()
        loss, _ = train.train_loss(model, train.batch_tensors(b, device), b,
                                   lw, tf_ratio, generator, coins)
        loss.backward()
        opt.step()
        return loss.detach()

    monkeypatch.setattr(train, "batch_tensors", batch_tensors64)
    monkeypatch.setattr(tune, "RankSchedulePredictor",
                        lambda cfg: RankSchedulePredictor(cfg).double())
    monkeypatch.setattr(tune, "init_params", init_from_jax)
    monkeypatch.setattr(tune, "train_step", step_with_coins)
    port_trial = StubTrial(TRIAL)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = tune.objective(port_trial, args)
    finally:
        torch.set_num_threads(n)
    assert len(port_trial.reports) == len(jax_trial.reports) == 1
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(port_trial.reports[0][1],
                               jax_trial.reports[0][1], rtol=1e-6)
