"""Predict rank schedules for every benchmark instance -> benchmark/r_sched/.

The port's twin of the repository's ``scripts/predict_all.py``: one model
load, one prediction per ``benchmark/instances/*/*.dat-s`` name, from the
processed graph in ``<root>/proc/<name>.npz`` when there is one (the
instance file itself need not exist), else by processing the ``.dat-s`` on
the host.  Each writes ``<out>/<name>.json`` = {"name", "rank_schedule",
"schedule_length", "checkpoint"}, the artifact ``bench.py``'s schedule mode
reads.  It predicts on ``cuda:0`` unless ``--device cpu`` (or ``--cpu``) is
given; without a GPU it stops with an error.

    python -m ltr_lowrank_sdp_torch.scripts.predict_all -c runs/r5 \\
        --out /tmp/r_sched [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Tuple

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--checkpoint", default="runs/r5")
    ap.add_argument("--instances", default="benchmark/instances")
    ap.add_argument("--out", default="benchmark/r_sched")
    ap.add_argument("--root", default="dataset")
    ap.add_argument("--cpu", action="store_true",
                    help="predict on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    return ap


def predict_all(checkpoint: str, instances: str, out: str, root: str,
                device=None) -> List[Tuple[dict, np.ndarray]]:
    """Write every instance's artifact; returns (artifact, unrounded
    schedule) per instance, in name order."""
    from ..data.loader import _load_graph_file
    from ..data.processor import process_sdpa_to_graph
    from ..models.checkpoint import load_model, predict_raw, schedule_from_raw

    model, _ = load_model(checkpoint, device=device)
    os.makedirs(out, exist_ok=True)
    done = []
    for path in sorted(glob.glob(os.path.join(instances, "*", "*.dat-s"))):
        name = os.path.basename(path)[: -len(".dat-s")]
        cached = os.path.join(root, "proc", name + ".npz")
        if os.path.exists(cached):
            graph = _load_graph_file(cached)
        else:
            graph = process_sdpa_to_graph(path, None)
        raw, L = predict_raw(model, graph)
        sched = schedule_from_raw(raw, L)
        artifact = {
            "name": name,
            "rank_schedule": [int(r) for r in sched],
            "schedule_length": int(L),
            "checkpoint": checkpoint,
        }
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"{name:>24}: L={L} {sched}")
        done.append((artifact, raw))
    return done


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from .. import resolve_device

    dev = resolve_device("cpu" if args.cpu else args.device)
    predict_all(args.checkpoint, args.instances, args.out, args.root, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
