"""Hyperparameter optimization for the rank predictor (Optuna).

The port's twin of the repository's root ``tune.py``: TPE/CmaEs/random
samplers + MedianPruner, search over architecture (hidden 32-96, layers 2-4,
heads 2/4), loss weights, optimizer settings and batch size, with a 600k
parameter-budget guard (an over-budget model is a pruned trial); emits
best.json, importance.json and all_trials.json.  Each trial trains with the
pieces of :mod:`.train` (its step, the clip + AdamW of its optimizer, the
batches shuffled with ``seed + epoch``) at teacher forcing 0.7 and reports
the validation log-MAE after every epoch.

``optuna`` is imported by :func:`main` alone, as the root ``tune.py``
imports it; where it is not installed the CLI stops there, as the root's
does.  It trains on ``cuda:0`` unless ``--device cpu`` (or ``--cpu``) is
given; without a GPU it stops with an error.

    python -m ltr_lowrank_sdp_torch.tune --root dataset --n-trials 50 \\
        --output-dir runs/tune [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .data.loader import create_splits, iterate_batches
from .models.loss import LossWeights
from .models.net import (ModelConfig, RankSchedulePredictor,
                         count_parameters, init_params)
from .optim import TrainOptimizer
from .train import evaluate, step_generator, train_step

PARAM_BUDGET = 600_000
# the root tune.py's teacher-forcing ratio, gradient clip and step key
# (fold_in(rng, epoch * 1000 + nb))
TF_RATIO = 0.7
CLIP_NORM = 1.0
STEP_STRIDE = 1000


def build_model_config(trial) -> ModelConfig:
    """Architecture search space (reference ``tune.py:32-62``)."""
    hidden = trial.suggest_int("hidden_dim", 32, 96, step=16)
    heads = trial.suggest_categorical("num_heads", [2, 4])
    hidden = (hidden // heads) * heads
    return ModelConfig(
        hidden_dim=hidden,
        edge_dim=trial.suggest_int("edge_dim", 16, 64, step=16),
        global_dim=trial.suggest_int("global_dim", 16, 64, step=16),
        num_gnn_layers=trial.suggest_int("num_gnn_layers", 2, 4),
        num_heads=heads,
        decoder_hidden_dim=trial.suggest_int("decoder_hidden_dim", 48, 128,
                                             step=16),
        decoder_num_layers=trial.suggest_int("decoder_num_layers", 1, 2),
        dropout=trial.suggest_float("dropout", 0.05, 0.3),
    )


def build_loss_weights(trial) -> LossWeights:
    return LossWeights(
        length_weight=trial.suggest_float("length_weight", 0.2, 1.0),
        mono_weight=trial.suggest_float("mono_weight", 0.0, 0.3),
        initial_weight=trial.suggest_float("initial_weight", 0.1, 0.5),
        final_weight=trial.suggest_float("final_weight", 0.1, 0.5),
        under_weight=trial.suggest_float("under_weight", 1.5, 5.0),
    )


def count_and_guard(model: RankSchedulePredictor,
                    budget: int = PARAM_BUDGET) -> int:
    """Parameter-budget guard (reference ``tune.py:102``)."""
    n = count_parameters(model)
    if n > budget:
        raise ValueError(f"parameter budget exceeded: {n} > {budget}")
    return n


def objective(trial, args) -> float:
    """Train one trial's model for ``args.epochs_per_trial`` epochs; the
    best validation log-MAE."""
    from . import resolve_device

    dev = resolve_device("cpu" if args.cpu else args.device)
    cfg = build_model_config(trial)
    lw = build_loss_weights(trial)
    lr = trial.suggest_float("lr", 1e-4, 3e-3, log=True)
    wd = trial.suggest_float("weight_decay", 1e-6, 1e-3, log=True)
    batch_size = trial.suggest_categorical("batch_size", [8, 16, 32])

    ds, train_idx, val_idx, _ = create_splits(args.root, seed=args.seed)
    model = RankSchedulePredictor(cfg)
    try:
        count_and_guard(model)
    except (ValueError, RuntimeError) as e:
        import optuna

        raise optuna.TrialPruned(str(e))
    init_params(model, torch.Generator().manual_seed(args.seed))
    model.to(dev)
    opt = TrainOptimizer(model.parameters(), lr, wd, CLIP_NORM)

    best = float("inf")
    for epoch in range(args.epochs_per_trial):
        nb = 0
        for b in iterate_batches(ds, train_idx, batch_size, shuffle=True,
                                 seed=args.seed + epoch):
            train_step(model, opt, b, lw, TF_RATIO, step_generator(
                dev, args.seed, epoch, nb, stride=STEP_STRIDE), dev)
            nb += 1
        v = evaluate(model, ds, val_idx, batch_size, lw, dev)["log_mae"]
        best = min(best, v)
        trial.report(v, epoch)
        if trial.should_prune():
            import optuna

            raise optuna.TrialPruned()
    return best


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="HPO for rank predictor")
    ap.add_argument("--root", default="dataset")
    ap.add_argument("--n-trials", type=int, default=50)
    ap.add_argument("--epochs-per-trial", type=int, default=20)
    ap.add_argument("--sampler", choices=["tpe", "cmaes", "random"],
                    default="tpe")
    ap.add_argument("--output-dir", default="runs/tune")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from . import resolve_device

    resolve_device("cpu" if args.cpu else args.device)

    os.makedirs(args.output_dir, exist_ok=True)
    import optuna

    sampler = {
        "tpe": optuna.samplers.TPESampler(seed=args.seed),
        "cmaes": optuna.samplers.CmaEsSampler(seed=args.seed),
        "random": optuna.samplers.RandomSampler(seed=args.seed),
    }[args.sampler]
    study = optuna.create_study(
        direction="minimize", sampler=sampler,
        pruner=optuna.pruners.MedianPruner(n_warmup_steps=5),
    )
    study.optimize(lambda t: objective(t, args), n_trials=args.n_trials)

    with open(os.path.join(args.output_dir, "best.json"), "w") as f:
        json.dump({"value": study.best_value, "params": study.best_params},
                  f, indent=2)
    try:
        imp = optuna.importance.get_param_importances(study)
        with open(os.path.join(args.output_dir, "importance.json"), "w") as f:
            json.dump(imp, f, indent=2)
    except Exception:
        pass
    with open(os.path.join(args.output_dir, "all_trials.json"), "w") as f:
        json.dump([
            {"number": t.number, "value": t.value, "params": t.params,
             "state": str(t.state)}
            for t in study.trials
        ], f, indent=2)
    print(f"best val log-MAE: {study.best_value:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
