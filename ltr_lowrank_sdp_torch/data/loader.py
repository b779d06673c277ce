"""Dataset of (graph features, oracle-rank schedule) pairs + batching.

The counterpart of ``ltr_lowrank_sdp_tpu/data/loader.py``, which
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
(reference processor output) -- both load.

Batching (``collate``, ``iterate_batches``) keeps the JAX package's batch
membership, size budgets, flush rule and seeded shuffle, and pads the graph
axis as it does.  It does not pad the node and edge axes: the JAX collate
pads them to power-of-two envelopes for XLA's static shapes, with every dead
edge on one dead node, which a one-warp-per-destination kernel would walk
one edge after another.  A batch records the JAX envelopes (``n_pad``,
``e_pad``) instead, because the padding changes the numbers: ``GATv2Conv``
averages the self-loops' edge feature over all ``e_pad`` encoded rows, and
the model corrects for that (``net.GNNEncoder.edge_fill``).  Dead nodes have
no effect: each sits in the dead graph, which the segment ops drop, and no
real node receives an edge from one.
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


# --------------------------------------------------------------------------- #
# batching
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class GraphBatch:
    x: np.ndarray            # (N, 16) the real nodes only
    edge_index: np.ndarray   # (2, E) the real edges only
    edge_attr: np.ndarray    # (E, 5)
    batch: np.ndarray        # (N,) graph id, sorted
    global_attr: np.ndarray  # (B, 17); rows past the samples are zeros
    schedule: np.ndarray     # (B, T)
    mask: np.ndarray         # (B, T); zero on the padding rows
    length: np.ndarray       # (B,)
    num_graphs: int          # B (the graph axis, padded)
    n_pad: int               # the JAX collate's node envelope
    e_pad: int               # the JAX collate's edge envelope
    names: List[str] = dataclasses.field(default_factory=list)

    @property
    def envelope(self) -> Tuple[int, int]:
        return self.n_pad, self.e_pad


def collate(samples: List[GraphSample], node_mult: int = 256,
            edge_mult: int = 512,
            pad_graphs_to: Optional[int] = None) -> GraphBatch:
    """Concatenate graphs; pad the graph axis (global_attr / schedule /
    mask / length) to ``pad_graphs_to`` with empty graphs of mask 0, as the
    JAX collate does, and record its power-of-two node / edge envelopes
    (``loader.py:196-197``) without materialising them."""
    B = len(samples)
    B_out = max(B, pad_graphs_to or B)
    n_total = sum(s.x.shape[0] for s in samples)
    e_total = sum(s.edge_index.shape[1] for s in samples)
    n_pad = max(node_mult, 1 << int(n_total).bit_length())
    e_pad = max(edge_mult, 1 << int(max(e_total - 1, 1)).bit_length())

    counts = np.zeros((B_out,), np.int64)      # nodes per graph
    counts[:B] = [s.x.shape[0] for s in samples]
    offsets = np.concatenate([[0], np.cumsum(counts[:B])[:-1]])
    x = np.concatenate([s.x for s in samples]).astype(np.float32)
    ei = np.concatenate([s.edge_index + off
                         for s, off in zip(samples, offsets)], axis=1)
    ea = np.concatenate([s.edge_attr for s in samples]).astype(np.float32)
    g = np.zeros((B_out, samples[0].global_attr.shape[0]), np.float32)
    T = samples[0].schedule.shape[0]
    sched = np.zeros((B_out, T), np.float32)
    mask = np.zeros((B_out, T), np.float32)
    length = np.zeros((B_out,), np.int64)
    for i, s in enumerate(samples):
        g[i] = s.global_attr
        sched[i] = s.schedule
        mask[i] = s.mask
        length[i] = s.length
    return GraphBatch(
        x=x, edge_index=ei.astype(np.int64), edge_attr=ea,
        batch=np.repeat(np.arange(B_out), counts), global_attr=g,
        schedule=sched, mask=mask, length=length, num_graphs=B_out,
        n_pad=n_pad, e_pad=e_pad,
        names=[s.name for s in samples])


def iterate_batches(ds: SDPDataset, indices: Sequence[int], batch_size: int,
                    shuffle: bool = False, seed: int = 0,
                    edge_budget: int = 1_500_000,
                    node_budget: int = 120_000):
    """Yield collated batches, capped by count AND size budgets.

    A batch flushes before adding a sample that would push it past
    ``edge_budget`` / ``node_budget``; an oversized sample still forms its
    own singleton batch (``MC_600x600_r5``, 2.5M edges)."""
    order = list(indices)
    if shuffle:
        random.Random(seed).shuffle(order)
    buf: List[GraphSample] = []
    n_tot = e_tot = 0
    for i in order:
        s = ds.get(i)
        if s is None:
            continue
        ni, ei = s.x.shape[0], s.edge_index.shape[1]
        if buf and (n_tot + ni > node_budget or e_tot + ei > edge_budget):
            yield collate(buf, pad_graphs_to=batch_size)
            buf, n_tot, e_tot = [], 0, 0
        buf.append(s)
        n_tot += ni
        e_tot += ei
        if len(buf) == batch_size:
            yield collate(buf, pad_graphs_to=batch_size)
            buf, n_tot, e_tot = [], 0, 0
    if buf:
        yield collate(buf, pad_graphs_to=batch_size)
