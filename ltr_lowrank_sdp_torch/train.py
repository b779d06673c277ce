"""Train the GATv2+LSTM rank-schedule predictor (PyTorch).

    python -m ltr_lowrank_sdp_torch.train --root dataset --output-dir runs/new
    python -m ltr_lowrank_sdp_torch.train --init-from runs/r5 --epochs 25 \\
        --lr 4e-4 --warmup-epochs 2 --tf-start 0.7 --device cpu

The twin of the repository's root ``train.py``, with the same flags (plus
``--device``) and the same five output files: 5-term RankScheduleLoss,
linear teacher-forcing decay 0.9 -> 0.2, AdamW with cosine warmup (or
plateau) schedule and gradient clipping as optax computes them
(:mod:`..optim`), best-checkpoint selection by validation log-MAE, the eval
report with per-position errors, the ``default`` / ``prac`` modes (prac
excludes benchmark instances from training), ``--init-from`` and
``--name-prefix``.  Checkpoints are Flax msgpack (``model.msgpack``) +
``config.json``, readable by the JAX package's ``load_model``.

It runs on ``cuda:0`` unless ``--device cpu`` (or ``--cpu``) is given;
without a GPU it stops with an error.  On the GPU each GATv2 layer of a
training step is one launch of K9 forward and one of K11 backward, the
poolings one of K10 and one of K12.  Randomness comes from explicit
generators: the initial parameters from ``--seed``, the dropout masks and
teacher-forcing coins of step ``nb`` of epoch ``e`` from a generator seeded
with (seed, 10000 e + nb), as the JAX package folds its key.  The JAX
package's reference defects are kept: the loss's length and final-rank terms
average over the rows that pad the graph axis, the padded edge envelope moves
the self-loops' edge feature, and ``--scheduler plateau`` keeps a constant
learning rate.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .data.loader import (GraphBatch, create_splits, get_benchmark_names,
                          iterate_batches)
from .models.checkpoint import load_model, save_checkpoint
from .models.loss import LossWeights, rank_schedule_loss
from .models.net import (ModelConfig, RankSchedulePredictor,
                         count_parameters, eval_mode, init_params)
from .optim import TrainOptimizer, warmup_cosine_decay_schedule


def get_teacher_forcing_ratio(epoch: int, total_epochs: int,
                              start: float = 0.9, end: float = 0.2) -> float:
    """Linear decay (reference ``train.py:202-217``)."""
    if total_epochs <= 1:
        return end
    frac = min(epoch / (total_epochs - 1), 1.0)
    return start + (end - start) * frac


def eval_report(test: dict) -> str:
    """Text report over free-running test predictions.

    Same sections as the reference report (``train.py:529-595``): headline
    metrics, length distribution, per-position errors (first 5 positions),
    and sample prediction/target pairs.
    """
    lines = ["[eval report]"]
    lines.append(f"  total loss: {test['loss']:.4f}")
    lines.append(f"  log mae: {test['log_mae']:.4f}")
    lines.append(f"  mae: {test['mae']:.4f}")
    lines.append(f"  length accuracy: {test['length_acc']:.2%}")
    lines.append(f"  exact length matches: {test['exact_length_count']}")
    lines.append("")

    preds, targets = test["predictions"], test["targets"]
    pred_lens = np.array(test["pred_lengths"])
    tgt_lens = np.array(test["target_lengths"])
    if preds and targets:
        lines.append("[length distribution]")
        len_err = pred_lens - tgt_lens
        lines.append(
            f"  target lengths: mean={tgt_lens.mean():.2f}, "
            f"std={tgt_lens.std():.2f}, min={tgt_lens.min()}, "
            f"max={tgt_lens.max()}")
        lines.append(
            f"  pred lengths: mean={pred_lens.mean():.2f}, "
            f"std={pred_lens.std():.2f}, min={pred_lens.min()}, "
            f"max={pred_lens.max()}")
        lines.append(f"  length error: mean={len_err.mean():.2f}, "
                     f"std={len_err.std():.2f}")
        lines.append("")

        lines.append("[per-position error]")
        max_pos = min(5, max(len(t) for t in targets))
        for pos in range(max_pos):
            errs = np.array([p[pos] - t[pos] for p, t in zip(preds, targets)
                             if pos < len(p) and pos < len(t)])
            if errs.size:
                lines.append(
                    f"  position {pos + 1}: mean_err={errs.mean():.2f}, "
                    f"std={errs.std():.2f}, "
                    f"|mean_err|={np.abs(errs).mean():.2f}")
        lines.append("")

        lines.append("[sample predictions]")
        for i in range(min(10, len(preds))):
            ell = "..." if len(preds[i]) > 8 else ""
            lines.append(f"  [{i + 1}] pred: {preds[i][:8]}{ell}")
            ell = "..." if len(targets[i]) > 8 else ""
            lines.append(f"       true: {targets[i][:8]}{ell}")
    return "\n".join(lines) + "\n"


def build_argparser():
    ap = argparse.ArgumentParser(description="train rank-schedule predictor")
    ap.add_argument("--root", default="dataset",
                    help="dir with proc/ + sol_json/")
    ap.add_argument("--output-dir", default="runs/rank_predictor")
    ap.add_argument("--mode", choices=["default", "prac"], default="default")
    ap.add_argument("--benchmark-dir", default="benchmark")
    # architecture (reference Optuna-tuned defaults, train.py:661-750)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--edge-dim", type=int, default=32)
    ap.add_argument("--global-dim", type=int, default=32)
    ap.add_argument("--num-gnn-layers", type=int, default=3)
    ap.add_argument("--num-heads", type=int, default=4)
    ap.add_argument("--decoder-hidden-dim", type=int, default=96)
    ap.add_argument("--decoder-num-layers", type=int, default=2)
    ap.add_argument("--max-seq-len", type=int, default=16)
    ap.add_argument("--dropout", type=float, default=0.15)
    # loss
    ap.add_argument("--schedule-weight", type=float, default=1.0)
    ap.add_argument("--length-weight", type=float, default=0.5)
    ap.add_argument("--mono-weight", type=float, default=0.1)
    ap.add_argument("--initial-weight", type=float, default=0.25)
    ap.add_argument("--final-weight", type=float, default=0.25)
    ap.add_argument("--under-weight", type=float, default=3.67)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    # optimization
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--warmup-epochs", type=int, default=10)
    ap.add_argument("--scheduler", choices=["cosine", "plateau"],
                    default="cosine")
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--tf-start", type=float, default=0.9)
    ap.add_argument("--tf-end", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--init-from", default=None,
                    help="checkpoint dir to warm-start parameters from")
    ap.add_argument("--name-prefix", nargs="*", default=None,
                    help="restrict the dataset to instances with these "
                         "name prefixes (family-specialist fine-tune)")
    return ap


def batch_tensors(b: GraphBatch, device) -> dict:
    """The arrays of one collated batch as tensors on ``device``."""
    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return {"x": t(b.x, torch.float32), "edge_index": t(b.edge_index,
                                                        torch.long),
            "edge_attr": t(b.edge_attr, torch.float32),
            "batch": t(b.batch, torch.long),
            "global_attr": t(b.global_attr, torch.float32),
            "schedule": t(b.schedule, torch.float32),
            "mask": t(b.mask, torch.float32),
            "length": t(b.length, torch.long)}


def step_generator(device, seed: int, epoch: int, nb: int) -> torch.Generator:
    """The generator of the dropout masks and coins of step ``nb`` of
    ``epoch`` (the JAX package's ``fold_in(rng, epoch * 10000 + nb)``)."""
    return torch.Generator(device=device).manual_seed(
        (seed << 32) + epoch * 10000 + nb)


def train_loss(model: RankSchedulePredictor, t: dict, b: GraphBatch,
               lw: LossWeights, tf_ratio: float,
               generator: Optional[torch.Generator] = None,
               coins: Optional[torch.Tensor] = None):
    """The loss of one training step (the root ``train.py``'s ``loss_fn``)
    -> (loss, components)."""
    preds, ll, ir = model(
        t["x"], t["edge_index"], t["edge_attr"], t["batch"],
        t["global_attr"], b.num_graphs, target_schedule=t["schedule"],
        target_mask=t["mask"], teacher_forcing_ratio=tf_ratio,
        generator=generator, coins=coins, envelope=b.envelope)
    return rank_schedule_loss(preds, t["schedule"], ll, t["length"],
                              t["mask"], ir, lw)


def train_step(model: RankSchedulePredictor, opt: TrainOptimizer,
               b: GraphBatch, lw: LossWeights, tf_ratio: float,
               generator: torch.Generator, device) -> torch.Tensor:
    """One training step on batch ``b``: forward in training mode, backward,
    optimizer -> the loss (a device scalar)."""
    model.train()
    loss, _ = train_loss(model, batch_tensors(b, device), b, lw, tf_ratio,
                         generator)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate(model: RankSchedulePredictor, ds, indices, batch_size: int,
             lw: LossWeights, device, collect: bool = False) -> dict:
    """The teacher-forced loss and metrics and, with ``collect``, the
    free-running predictions per row (the root ``train.py``'s ``evaluate``;
    the rows that pad the graph axis count as it counts them)."""
    tot_loss, n_batches = 0.0, 0
    log_mae_sum, mae_sum, n_valid = 0.0, 0.0, 0.0
    len_correct, len_total = 0, 0
    preds_out, targets_out = [], []
    pred_lens_out, target_lens_out, names_out = [], [], []
    with eval_mode(model), torch.no_grad():
        for b in iterate_batches(ds, indices, batch_size):
            t = batch_tensors(b, device)
            preds, ll, ir = model(
                t["x"], t["edge_index"], t["edge_attr"], t["batch"],
                t["global_attr"], b.num_graphs,
                target_schedule=t["schedule"], teacher_forcing_ratio=1.0,
                envelope=b.envelope)
            loss, _ = rank_schedule_loss(preds, t["schedule"], ll,
                                         t["length"], t["mask"], ir, lw)
            tot_loss += float(loss)
            n_batches += 1
            p = preds.cpu().numpy()
            tt, m = b.schedule, b.mask
            log_err = np.abs(np.log(np.maximum(p, 1e-6))
                             - np.log(np.maximum(tt, 1e-6))) * m
            log_mae_sum += log_err.sum()
            mae_sum += (np.abs(p - tt) * m).sum()
            n_valid += m.sum()
            pred_len = np.argmax(ll.cpu().numpy(), axis=-1) + 1
            true_len = b.length
            len_correct += int(np.sum(pred_len == true_len))
            len_total += b.num_graphs
            if collect:
                frs, frl = model.predict(
                    t["x"], t["edge_index"], t["edge_attr"], t["batch"],
                    t["global_attr"], b.num_graphs, envelope=b.envelope)
                fr_s, fr_l = frs.cpu().numpy(), frl.cpu().numpy()
                for i in range(b.num_graphs):
                    pl, tl = int(fr_l[i]), int(true_len[i])
                    preds_out.append([int(round(v)) for v in fr_s[i, :pl]])
                    targets_out.append([int(round(v)) for v in tt[i, :tl]])
                    pred_lens_out.append(pl)
                    target_lens_out.append(tl)
                    names_out.append(b.names[i] if i < len(b.names)
                                     else None)
    out = {
        "loss": tot_loss / max(n_batches, 1),
        "log_mae": log_mae_sum / max(n_valid, 1),
        "mae": mae_sum / max(n_valid, 1),
        "length_acc": len_correct / max(len_total, 1),
    }
    if collect:
        out["predictions"] = preds_out
        out["targets"] = targets_out
        out["pred_lengths"] = pred_lens_out
        out["target_lengths"] = target_lens_out
        out["names"] = names_out
        out["exact_length_count"] = int(sum(
            pl == tl for pl, tl in zip(pred_lens_out, target_lens_out)))
    return out


def make_optimizer(model, args, steps_per_epoch: int) -> TrainOptimizer:
    """The root ``train.py``'s optax chain for these flags."""
    if args.scheduler == "cosine":
        # clamp warmup below the run length, as the JAX package does
        warmup_epochs = min(args.warmup_epochs, max(args.epochs - 1, 0))
        lr = warmup_cosine_decay_schedule(
            0.0, args.lr, warmup_epochs * steps_per_epoch,
            args.epochs * steps_per_epoch, end_value=args.lr * 1e-2)
    else:
        # plateau keeps lr constant: the JAX package computes an lr scale
        # that nothing reads
        lr = args.lr
    return TrainOptimizer(model.parameters(), lr, args.weight_decay,
                          args.clip_norm, args.grad_accum)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else args.device)

    os.makedirs(args.output_dir, exist_ok=True)
    exclude = None
    if args.mode == "prac":
        exclude = get_benchmark_names(args.benchmark_dir)
        print(f"prac mode: excluding {len(exclude)} benchmark instances")

    ds, train_idx, val_idx, test_idx = create_splits(
        args.root, seed=args.seed, max_schedule_length=args.max_seq_len,
        exclude_names=exclude,
    )
    if args.name_prefix:
        # family-specialist fine-tune: restrict every split to instances
        # whose name starts with one of the given prefixes
        prefixes = tuple(args.name_prefix)
        train_idx, val_idx, test_idx = (
            [i for i in idx if ds.samples[i][0].startswith(prefixes)]
            for idx in (train_idx, val_idx, test_idx))
        print(f"name-prefix filter {args.name_prefix}: "
              f"train {len(train_idx)} / val {len(val_idx)} / "
              f"test {len(test_idx)}")
    print(f"dataset: {len(ds)} samples (train {len(train_idx)} / val "
          f"{len(val_idx)} / test {len(test_idx)})")

    cfg = ModelConfig(
        hidden_dim=args.hidden_dim, edge_dim=args.edge_dim,
        global_dim=args.global_dim, num_gnn_layers=args.num_gnn_layers,
        num_heads=args.num_heads, decoder_hidden_dim=args.decoder_hidden_dim,
        decoder_num_layers=args.decoder_num_layers,
        max_seq_len=args.max_seq_len, dropout=args.dropout,
    )
    model = RankSchedulePredictor(cfg)
    lw = LossWeights(
        schedule_weight=args.schedule_weight, length_weight=args.length_weight,
        mono_weight=args.mono_weight, initial_weight=args.initial_weight,
        final_weight=args.final_weight, under_weight=args.under_weight,
        label_smoothing=args.label_smoothing,
    )
    init_params(model, torch.Generator().manual_seed(args.seed))
    model.to(dev)
    if args.init_from:
        # warm start / fine-tune: overwrite the freshly-initialised params
        # with a compatible checkpoint
        model.load_state_dict(
            load_model(args.init_from, device=dev)[0].state_dict())
        print(f"warm start from {args.init_from}")
    print(f"model parameters: {count_parameters(model):,}")

    steps_per_epoch = max(1, (len(train_idx) + args.batch_size - 1)
                          // args.batch_size)
    opt = make_optimizer(model, args, steps_per_epoch)

    best_val = float("inf")
    history = []
    t_start = time.time()
    for epoch in range(args.epochs):
        tf_ratio = get_teacher_forcing_ratio(
            epoch, args.epochs, args.tf_start, args.tf_end
        )
        ep_loss, nb = 0.0, 0
        for b in iterate_batches(ds, train_idx, args.batch_size,
                                 shuffle=True, seed=args.seed + epoch):
            loss = train_step(model, opt, b, lw, tf_ratio,
                              step_generator(dev, args.seed, epoch, nb), dev)
            ep_loss += float(loss)
            nb += 1
        val = (evaluate(model, ds, val_idx, args.batch_size, lw, dev)
               if val_idx else {"log_mae": ep_loss})
        val = {k: (float(v) if isinstance(v, (int, float, np.floating))
                   else v) for k, v in val.items()}
        history.append({
            "epoch": epoch, "train_loss": ep_loss / max(nb, 1),
            "tf_ratio": tf_ratio, **{f"val_{k}": v for k, v in val.items()},
        })
        print(f"epoch {epoch:3d} train_loss {ep_loss / max(nb, 1):.4f} "
              f"val_log_mae {val.get('log_mae', float('nan')):.4f} "
              f"tf {tf_ratio:.2f} ({time.time() - t_start:.0f}s)",
              flush=True)
        if val.get("log_mae", float("inf")) < best_val:
            best_val = val["log_mae"]
            save_checkpoint(args.output_dir, model, cfg,
                            {"best_val_log_mae": float(best_val),
                             "epoch": epoch})

    test = (evaluate(model, ds, test_idx, args.batch_size, lw, dev,
                     collect=True) if test_idx else {})
    if test:
        with open(os.path.join(args.output_dir, "eval_report.txt"), "w") as f:
            f.write(eval_report(test))
        with open(os.path.join(args.output_dir,
                               "eval_predictions.json"), "w") as f:
            json.dump({
                "predictions": test["predictions"],
                "targets": test["targets"],
                "pred_lengths": test["pred_lengths"],
                "target_lengths": test["target_lengths"],
                "names": test["names"],
            }, f, indent=2)
    test_scalars = {k: v for k, v in test.items()
                    if not isinstance(v, list)}
    report = {
        "best_val_log_mae": best_val,
        "test": test_scalars,
        "history": history,
        "params": vars(args),
    }
    with open(os.path.join(args.output_dir, "training_log.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(f"done. best val log-MAE {best_val:.4f}; test: {test_scalars}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
