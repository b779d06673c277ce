"""Inference CLI of the PyTorch port: predict a rank schedule for one
instance or for the seeded test split.

    python -m ltr_lowrank_sdp_torch.infer -c runs/r5_theta -i theta_n300_d75
    python -m ltr_lowrank_sdp_torch.infer -c runs/r5_theta --batch --output preds.json
    python -m ltr_lowrank_sdp_torch.infer -c runs/r5_theta -i inst.dat-s --device cpu

The twin of the repository's root ``infer.py``: loads a checkpoint (config
fallback), resolves the input (graph file or raw .dat-s, processed on the
fly), runs the predictor, and if the instance has a solver JSON with a
ground-truth trajectory, reports schedule-comparison metrics (log-MAE per
position, length error, final-rank error).  Batch mode re-derives the
seeded test split and aggregates.  The predictor runs on ``cuda:0`` unless
``--device cpu`` (or ``--cpu``) is given; without a GPU it stops with an
error.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import resolve_device


def compute_schedule_metrics(pred, gt):
    """Schedule comparison (reference ``infer.py:237-289``)."""
    L = min(len(pred), len(gt))
    if L == 0:
        return {}
    p = np.maximum(np.asarray(pred[:L], float), 1e-6)
    g = np.maximum(np.asarray(gt[:L], float), 1e-6)
    log_err = np.abs(np.log(p) - np.log(g))
    return {
        "log_mae": float(log_err.mean()),
        "mae": float(np.abs(p - g).mean()),
        "length_pred": len(pred),
        "length_gt": len(gt),
        "length_error": abs(len(pred) - len(gt)),
        "final_rank_pred": int(pred[-1]),
        "final_rank_gt": int(gt[-1]),
        "final_rank_error": abs(int(pred[-1]) - int(gt[-1])),
    }


def resolve_graph(path_or_name: str, root: str):
    """Find/build the graph features for an instance."""
    from .data.loader import _load_graph_file
    from .data.processor import process_sdpa_to_graph

    cands = [
        path_or_name,
        os.path.join(root, "proc", path_or_name + ".npz"),
        os.path.join(root, "proc", path_or_name + ".pt"),
    ]
    for c in cands:
        if os.path.exists(c) and (c.endswith(".npz") or c.endswith(".pt")):
            return _load_graph_file(c), os.path.splitext(os.path.basename(c))[0]
    if os.path.exists(path_or_name) and path_or_name.endswith(".dat-s"):
        name = os.path.basename(path_or_name)[: -len(".dat-s")]
        return process_sdpa_to_graph(path_or_name, None), name
    raise FileNotFoundError(f"cannot resolve instance: {path_or_name}")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="rank-schedule inference")
    ap.add_argument("-c", "--checkpoint", required=True)
    ap.add_argument("-i", "--input", default=None,
                    help="instance name, graph file, or .dat-s path")
    ap.add_argument("--root", default="dataset")
    ap.add_argument("--batch", action="store_true",
                    help="evaluate the seeded test split")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--min-rank", type=int, default=1)
    ap.add_argument("--output", default=None, help="write predictions JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the predictor runs (default: the first GPU)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the same as --device cpu, the "
                         "root script's flag)")
    return ap


def main(argv=None):
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    # a missing GPU is reported before anything is read
    device = resolve_device(
        "cpu" if args.cpu or args.device == "cpu" else None)

    from .models.checkpoint import load_model, predict_schedule_for_graph

    model, _ = load_model(args.checkpoint, device=device)

    if args.batch:
        from .data.loader import create_splits

        ds, _, _, test_idx = create_splits(args.root, seed=args.seed)
        results = {}
        aggr = []
        for i in test_idx:
            s = ds.get(i)
            if s is None:
                continue
            graph = {"x": s.x, "edge_index": s.edge_index,
                     "edge_attr": s.edge_attr, "global_attr": s.global_attr}
            pred, L = predict_schedule_for_graph(model, graph, args.min_rank)
            gt = s.schedule[: s.length].astype(int).tolist()
            met = compute_schedule_metrics(pred, gt)
            results[s.name] = {"pred": pred, "gt": gt, **met}
            if met:
                aggr.append(met)
        if aggr:
            print(f"test instances: {len(aggr)}")
            for k in ("log_mae", "mae", "length_error", "final_rank_error"):
                vals = [a[k] for a in aggr]
                print(f"  {k:>18}: mean {np.mean(vals):.4f} "
                      f"median {np.median(vals):.4f}")
        if args.output:
            with open(args.output, "w") as f:
                json.dump(results, f, indent=2)
        return 0

    if not args.input:
        ap.error("--input required unless --batch")
    graph, name = resolve_graph(args.input, args.root)
    pred, L = predict_schedule_for_graph(model, graph, args.min_rank)
    print(f">>> {name}")
    print(f"predicted schedule ({L} steps): {pred}")

    gt_path = os.path.join(args.root, "sol_json", name + ".json")
    if os.path.exists(gt_path):
        from .data.loader import extract_rank_schedule

        with open(gt_path) as f:
            payload = json.load(f)
        gt = extract_rank_schedule(payload.get("trajectory", {}))
        if gt:
            print(f"ground truth ({len(gt)} steps): {gt}")
            met = compute_schedule_metrics(pred, gt)
            for k, v in met.items():
                print(f"  {k}: {v}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"name": name, "schedule": pred,
                       "schedule_length": L}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
