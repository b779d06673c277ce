"""Dataset of (graph features, oracle-rank schedule) pairs, for inference.

The inference part of ``ltr_lowrank_sdp_tpu/data/loader.py``, which
re-implements the reference loader contract (``dataset/loader.py``):
* label = de-duplicated consecutive ``oracle_rank`` sequence across
  phase_1 + phase_2 of the solver trajectory JSON (``:18-45``);
* schedules padded/truncated to ``max_schedule_length`` (16) with a binary
  mask (``:70-91``);
* schedule-type classification constant/increasing/decreasing/mixed;
* seeded shuffle + 90/5/5 split (``:292-376``), the same indices as the JAX
  package's for the same seed;
* benchmark-instance exclusion by name.

Graphs are stored as ``.npz`` (the processor's output) or torch ``.pt``
(reference processor output) -- both load.  The batching of training
(``collate``, ``iterate_batches``) comes with the training slice.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MAX_SCHEDULE_LENGTH = 16


def extract_rank_schedule(trajectory: Dict) -> List[int]:
    p1 = trajectory.get("phase_1", {}).get("oracle_rank", [])
    p2 = trajectory.get("phase_2", {}).get("oracle_rank", [])
    out: List[int] = []
    for r in list(p1) + list(p2):
        if not out or out[-1] != r:
            out.append(int(r))
    return out


def classify_schedule_type(schedule: List[int]) -> str:
    if len(schedule) <= 1:
        return "constant"
    diffs = [b - a for a, b in zip(schedule, schedule[1:])]
    if all(d >= 0 for d in diffs):
        return "increasing"
    if all(d <= 0 for d in diffs):
        return "decreasing"
    return "mixed"


def pad_schedule(schedule: List[int], max_length: int,
                 pad_value: int = 0) -> Tuple[List[int], int]:
    n = len(schedule)
    if n >= max_length:
        return schedule[:max_length], min(n, max_length)
    return schedule + [pad_value] * (max_length - n), n


@dataclasses.dataclass
class GraphSample:
    name: str
    x: np.ndarray            # (m, 16)
    edge_index: np.ndarray   # (2, E)
    edge_attr: np.ndarray    # (E, 5)
    global_attr: np.ndarray  # (17,)
    schedule: np.ndarray     # (T,) float
    mask: np.ndarray         # (T,)
    length: int
    schedule_type: str = "constant"


def _load_graph_file(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    # torch .pt written by the reference processor
    data = torch.load(path, map_location="cpu", weights_only=False)
    return {
        "x": data.x.numpy(),
        "edge_index": data.edge_index.numpy(),
        "edge_attr": data.edge_attr.numpy(),
        "global_attr": data.global_attr.numpy().reshape(-1),
        "num_nodes": np.int64(data.num_nodes),
    }


class SDPDataset:
    """Pairs ``proc/*.npz|pt`` graphs with ``sol_json/*.json`` labels."""

    def __init__(self, root: str, max_schedule_length: int = MAX_SCHEDULE_LENGTH,
                 exclude_names: Optional[Sequence[str]] = None):
        self.root = Path(root)
        self.max_len = max_schedule_length
        self.exclude = set(exclude_names or [])
        self.samples = self._find_valid_samples()

    def _find_valid_samples(self) -> List[Tuple[str, str, str]]:
        proc = self.root / "proc"
        solj = self.root / "sol_json"
        found = []
        if not proc.exists() or not solj.exists():
            return found
        graph_files = {}
        for ext in ("*.npz", "*.pt"):
            for f in sorted(proc.glob(ext)):
                graph_files.setdefault(f.stem, str(f))
        for stem, gpath in sorted(graph_files.items()):
            if stem in self.exclude:
                continue
            jpath = solj / f"{stem}.json"
            if jpath.exists():
                found.append((stem, gpath, str(jpath)))
        return found

    def __len__(self):
        return len(self.samples)

    def get(self, idx: int) -> Optional[GraphSample]:
        name, gpath, jpath = self.samples[idx]
        graph = _load_graph_file(gpath)
        with open(jpath) as f:
            payload = json.load(f)
        sched = extract_rank_schedule(payload.get("trajectory", {}))
        if not sched:
            final = payload.get("metrics", {}).get("oracle_rank", 0)
            if final <= 0:
                return None
            sched = [int(final)]
        padded, length = pad_schedule(sched, self.max_len)
        mask = [1.0] * length + [0.0] * (self.max_len - length)
        return GraphSample(
            name=name,
            x=np.asarray(graph["x"], np.float32),
            edge_index=np.asarray(graph["edge_index"], np.int64),
            edge_attr=np.asarray(graph["edge_attr"], np.float32),
            global_attr=np.asarray(graph["global_attr"], np.float32).reshape(-1),
            schedule=np.asarray(padded, np.float32),
            mask=np.asarray(mask, np.float32),
            length=length,
            schedule_type=classify_schedule_type(sched),
        )

    def __getitem__(self, idx):
        return self.get(idx)


def get_benchmark_names(benchmark_dir: str = "benchmark") -> List[str]:
    path = Path(benchmark_dir)
    names = set()
    for sub, pat in (("pt", "*.pt"), ("pt", "*.npz"),
                     ("instances", "*.dat-s")):
        d = path / sub
        if d.exists():
            for f in d.rglob(pat):
                names.add(f.stem)
    return sorted(names)


def create_splits(
    root: str,
    seed: int = 42,
    train_split: float = 0.9,
    val_split: float = 0.05,
    test_split: float = 0.05,
    max_schedule_length: int = MAX_SCHEDULE_LENGTH,
    exclude_names: Optional[Sequence[str]] = None,
):
    """Seeded shuffle + split; returns (dataset, train_idx, val_idx, test_idx)."""
    if abs(train_split + val_split + test_split - 1.0) > 1e-6:
        raise ValueError("split ratios must sum to 1.0")
    ds = SDPDataset(root, max_schedule_length, exclude_names)
    n = len(ds)
    if n == 0:
        raise ValueError(f"no valid samples found in {root}")
    idx = list(range(n))
    rng = random.Random(seed)
    rng.shuffle(idx)
    t_end = int(train_split * n)
    v_end = int((train_split + val_split) * n)
    return ds, idx[:t_end], idx[t_end:v_end], idx[v_end:]
