"""SDP instance -> constraint-graph features.

A copy of ``ltr_lowrank_sdp_tpu/data/processor.py`` (numpy / scipy only),
reading through this package's SDPA reader.  It re-implements the reference
feature contract (``dataset/processor.py``): each constraint is a graph node
with **16 features**, structurally overlapping constraints are connected with
**5 edge features**, and the instance carries **17 global features**, so
that models and harvested datasets are interchangeable with the JAX
package's.

Differences from the reference implementation (not contract):
* the parser reuses the package's vectorized SDPA reader (objective kept
  un-negated and symmetrized like ``SDPAParser``, which drops LP blocks,
  ``processor.py:74``);
* pairwise loops are replaced by vectorized numpy / scipy.sparse ops;
* output is a plain ``.npz`` (x, edge_index, edge_attr, global_attr)
  instead of a torch ``.pt`` -- the loaders read either.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

NUM_NODE_FEATURES = 16
NUM_EDGE_FEATURES = 5
NUM_GLOBAL_FEATURES = 17
EPS = 1e-8


def _parse_for_features(path: str):
    """Parse SDPA into full symmetric CSR matrices on the concatenated
    block-diagonal index space (LP blocks dropped), mirroring
    ``SDPAParser`` (``dataset/processor.py:27-200``)."""
    from ..io.sdpa import read_sdpa

    data = read_sdpa(path)
    dims = data.block_dims
    offsets = np.concatenate([[0], np.cumsum(dims)]).astype(np.int64)
    n = int(offsets[-1])
    m = data.n_constrs

    c_rows, c_cols, c_vals = [], [], []
    a_rows, a_cols, a_vals, a_cid = [], [], [], []
    for k, blk in enumerate(data.blocks):
        off = offsets[k]
        # NOTE: our reader negates objective entries (solver convention);
        # the feature extractor uses raw file values -> undo the negation.
        c_rows.append(blk.c_rows.astype(np.int64) + off)
        c_cols.append(blk.c_cols.astype(np.int64) + off)
        c_vals.append(-blk.c_vals)
        a_rows.append(blk.a_rows.astype(np.int64) + off)
        a_cols.append(blk.a_cols.astype(np.int64) + off)
        a_vals.append(blk.a_vals)
        a_cid.append(blk.a_cid)

    def cat(xs, dtype=None):
        out = np.concatenate(xs) if xs else np.zeros(0)
        return out.astype(dtype) if dtype else out

    cr, cc, cv = cat(c_rows, np.int64), cat(c_cols, np.int64), cat(c_vals)
    ar, ac, av = cat(a_rows, np.int64), cat(a_cols, np.int64), cat(a_vals)
    ai = cat(a_cid, np.int64)

    def sym_csr(r, c, v):
        off_diag = r != c
        rr = np.concatenate([r, c[off_diag]])
        cc2 = np.concatenate([c, r[off_diag]])
        vv = np.concatenate([v, v[off_diag]])
        return sp.csr_matrix((vv, (rr, cc2)), shape=(n, n))

    C = sym_csr(cr, cc, cv)
    # the entries of constraint i in file order: a stable sort by id gives
    # each constraint's matrix from the same entry sequence as a mask would
    order = np.argsort(ai, kind="stable")
    ar, ac, av = ar[order], ac[order], av[order]
    bounds = np.searchsorted(ai[order], np.arange(m + 1))
    A = [sym_csr(ar[lo:hi], ac[lo:hi], av[lo:hi])
         for lo, hi in zip(bounds[:-1], bounds[1:])]
    b = data.b
    return C, A, b, m, n, offsets.tolist()


class FeatureExtractor:
    """Per-constraint / pairwise / global feature computation.

    Feature semantics match ``dataset/processor.py:203-748``.
    """

    EPS = EPS

    def __init__(self, C, A, b, m, n, block_offsets=None, verbose=False):
        self.C = C.tocsr()
        self.A = [a.tocsr() for a in A]
        self.b = np.asarray(b, np.float64)
        self.m = m
        self.n = n
        self.block_offsets = block_offsets or [0, n]
        self.nblocks = len(self.block_offsets) - 1
        self.verbose = verbose
        self._constraint_stats()
        self._cost_stats()

    # ---------------- per-constraint statistics ---------------- #

    def _constraint_stats(self):
        m = self.m
        self.norms = np.zeros(m)
        self.nnz_counts = np.zeros(m, np.int64)
        self.traces = np.zeros(m)
        self.diag_norms = np.zeros(m)
        self.gershgorin = np.zeros(m)
        self.blocks_touched = np.zeros(m, np.int64)
        self.row_indices: List[np.ndarray] = []
        self.row_sizes = np.zeros(m, np.int64)

        starts = np.array(self.block_offsets[:-1])
        ends = np.array(self.block_offsets[1:])
        for i, Ai in enumerate(self.A):
            self.nnz_counts[i] = Ai.nnz
            if Ai.nnz:
                self.norms[i] = np.sqrt(np.sum(Ai.data ** 2))
                d = Ai.diagonal()
                self.traces[i] = d.sum()
                self.diag_norms[i] = np.linalg.norm(d)
                row_sums = np.abs(Ai).sum(axis=1)
                row_sums = np.asarray(row_sums).ravel()
                self.gershgorin[i] = row_sums.max() if row_sums.size else 0.0
                coo = Ai.tocoo()
                rows = np.unique(coo.row)
                self.row_indices.append(rows)
                self.row_sizes[i] = rows.size
                if rows.size and self.nblocks > 1:
                    lo, hi = rows.min(), rows.max()
                    self.blocks_touched[i] = int(
                        np.sum((starts <= hi) & (ends > lo))
                    )
                else:
                    self.blocks_touched[i] = 1 if rows.size else 0
            else:
                self.row_indices.append(np.array([], np.int64))

        self.log_norms = np.log1p(self.norms)
        self.log_nnz = np.log1p(self.nnz_counts)
        self.normed_rhs = np.clip(self.b / (self.norms + EPS), -100.0, 100.0)
        self.mu_log_fro = self.log_norms.mean() if m else 0.0
        self.sigma_log_fro = (self.log_norms.std() if m else 0.0) + EPS
        self.mu_log_nnz = self.log_nnz.mean() if m else 0.0
        self.sigma_log_nnz = (self.log_nnz.std() if m else 0.0) + EPS
        self.mu_nrhs = np.abs(self.normed_rhs).mean() if m else 0.0
        self.sigma_nrhs = (np.abs(self.normed_rhs).std() if m else 0.0) + EPS
        self.fro_quantiles = (
            np.percentile(self.log_norms, [25, 50, 75]) if m
            else np.zeros(3)
        )
        # binary constraint-row incidence pattern for overlap computation
        rows_all, cols_all = [], []
        for i in range(m):
            ri = self.row_indices[i]
            if ri.size:
                rows_all.append(np.full(ri.size, i, np.int64))
                cols_all.append(ri)
        if rows_all:
            rr = np.concatenate(rows_all)
            cc = np.concatenate(cols_all)
            self.pattern = sp.csr_matrix(
                (np.ones(rr.size, np.float32), (rr, cc)),
                shape=(m, int(cc.max()) + 1),
            )
        else:
            self.pattern = None

    def _cost_stats(self):
        self.C_frob = (
            np.sqrt(np.sum(self.C.data ** 2)) if self.C.nnz else EPS
        )
        self.C_nnz = self.C.nnz
        coo = self.C.tocoo()
        self.C_row_indices = np.unique(coo.row) if self.C.nnz else np.array([])
        self.cos_with_C = np.zeros(self.m)
        if self.C.nnz:
            for i, Ai in enumerate(self.A):
                if Ai.nnz:
                    inner = (Ai.multiply(self.C)).sum()
                    self.cos_with_C[i] = inner / (
                        self.norms[i] * self.C_frob + EPS
                    )

    # ---------------- feature heads ---------------- #

    def compute_global_features(self) -> np.ndarray:
        """17 global features (``processor.py:353-435``)."""
        n_sq = float(self.n * self.n) + EPS
        m = self.m
        dens = self.nnz_counts / n_sq
        g = np.array([
            np.log1p(self.n),
            np.log1p(m),
            np.log1p(self.n / max(m, 1)),
            np.log1p(self.C_frob),
            np.log1p(self.norms.mean() if m else 0.0),
            dens.mean() if m else 0.0,
            dens.var() if m else 0.0,
            self.C_nnz / n_sq,
            self.log_norms.mean() if m else 0.0,
            self.log_norms.std() if m else 0.0,
            np.median(self.log_norms) if m else 0.0,
            self.cos_with_C.mean() if m else 0.0,
            self.cos_with_C.std() if m else 0.0,
            self.cos_with_C.max() if m else 0.0,
            self.cos_with_C.min() if m else 0.0,
            0.0,  # avg_degree — backfilled after edges
            0.0,  # degree_std — backfilled after edges
        ], np.float32)
        return g

    def compute_node_features(self) -> np.ndarray:
        """16 node features (``processor.py:437-518``)."""
        f = np.zeros((self.m, NUM_NODE_FEATURES), np.float32)
        if self.m == 0:
            return f
        f[:, 0] = self.log_norms
        f[:, 1] = self.log_nnz
        f[:, 2] = np.clip(self.traces / (self.norms + EPS), -100, 100)
        f[:, 3] = self.diag_norms / (self.norms + EPS)
        f[:, 4] = self.normed_rhs
        f[:, 5] = np.log1p(self.gershgorin)
        f[:, 6] = self.cos_with_C
        sign = np.zeros(self.m, np.float32)
        sign[self.cos_with_C > 0.01] = 1.0
        sign[self.cos_with_C < -0.01] = -1.0
        f[:, 7] = sign
        f[:, 8] = (self.log_norms - self.mu_log_fro) / self.sigma_log_fro
        f[:, 9] = (self.log_nnz - self.mu_log_nnz) / self.sigma_log_nnz
        f[:, 10] = (np.abs(self.normed_rhs) - self.mu_nrhs) / self.sigma_nrhs
        f[:, 11] = np.digitize(self.log_norms, self.fro_quantiles) / 3.0
        f[:, 12] = np.log1p(self.row_sizes)
        if self.C_row_indices.size:
            cset = set(self.C_row_indices.tolist())
            for i in range(self.m):
                if self.row_sizes[i]:
                    f[i, 13] = len(
                        set(self.row_indices[i].tolist()) & cset
                    ) / self.row_sizes[i]
        # f[:, 14] = log_degree — backfilled after edges
        f[:, 15] = np.log1p(self.blocks_touched)
        return f

    # ---------------- edges ---------------- #

    def compute_edges(self, max_neighbors=15, similarity_threshold=0.05):
        """Jaccard-overlap edges with 5 features (``processor.py:520-663``).

        m >= 1000 uses the P P^T sparse-overlap path with top-k neighbor
        truncation; smaller instances compare all pairs; a k-NN-on-norms
        fallback fires when no overlap edges exist.
        """
        if self.m == 0:
            return (np.zeros((2, 0), np.int64),
                    np.zeros((0, NUM_EDGE_FEATURES), np.float32))
        if self.m >= 1000 and self.pattern is not None:
            ei, ea = self._edges_sparse(max_neighbors, similarity_threshold)
        else:
            ei, ea = self._edges_full(similarity_threshold)
        if ei.shape[1] == 0:
            ei, ea = self._knn_fallback(max_neighbors)
        return ei, ea

    def _pair_features(self, i, js, overlaps, jaccards, exact_cos_limit=50):
        overlap_mins = overlaps / (
            np.minimum(self.row_sizes[i], self.row_sizes[js]) + EPS
        )
        log_min = np.minimum(self.log_norms[i], self.log_norms[js])
        fro_diff = np.abs(self.log_norms[i] - self.log_norms[js])
        if len(js) <= exact_cos_limit:
            cosines = np.array([
                abs((self.A[i].multiply(self.A[j])).sum())
                / (self.norms[i] * self.norms[j] + EPS)
                for j in js
            ])
        else:
            cosines = jaccards
        return np.stack(
            [jaccards, overlap_mins, cosines, log_min, fro_diff], axis=1
        ).astype(np.float32)

    def _edges_sparse(self, max_neighbors, threshold):
        overlap = (self.pattern @ self.pattern.T).tocsr()
        ei, ea = [], []
        for i in range(self.m):
            if self.row_sizes[i] == 0:
                continue
            lo, hi = overlap.indptr[i], overlap.indptr[i + 1]
            js = overlap.indices[lo:hi]
            ov = overlap.data[lo:hi].astype(np.float64)
            mask = js > i
            js, ov = js[mask], ov[mask]
            if js.size == 0:
                continue
            unions = self.row_sizes[i] + self.row_sizes[js] - ov
            jac = ov / (unions + EPS)
            valid = jac >= threshold
            js, ov, jac = js[valid], ov[valid], jac[valid]
            if js.size == 0:
                continue
            if js.size > max_neighbors:
                top = np.argpartition(-jac, max_neighbors)[:max_neighbors]
                js, ov, jac = js[top], ov[top], jac[top]
            feats = self._pair_features(i, js, ov, jac)
            for k, j in enumerate(js):
                ei.extend([[i, int(j)], [int(j), i]])
                ea.extend([feats[k], feats[k]])
        if not ei:
            return (np.zeros((2, 0), np.int64),
                    np.zeros((0, NUM_EDGE_FEATURES), np.float32))
        return np.array(ei, np.int64).T, np.array(ea, np.float32)

    def _edges_full(self, threshold):
        ei, ea = [], []
        sets = [set(r.tolist()) for r in self.row_indices]
        for i in range(self.m):
            if not sets[i]:
                continue
            for j in range(i + 1, self.m):
                if not sets[j]:
                    continue
                inter = len(sets[i] & sets[j])
                if inter == 0:
                    continue
                union = len(sets[i] | sets[j])
                jac = inter / union
                if jac < threshold:
                    continue
                feats = self._pair_features(
                    i, np.array([j]), np.array([inter], np.float64),
                    np.array([jac]),
                )[0]
                ei.extend([[i, j], [j, i]])
                ea.extend([feats, feats])
        if not ei:
            return (np.zeros((2, 0), np.int64),
                    np.zeros((0, NUM_EDGE_FEATURES), np.float32))
        return np.array(ei, np.int64).T, np.array(ea, np.float32)

    def _knn_fallback(self, k):
        k = min(k, self.m - 1)
        if k <= 0:
            return (np.zeros((2, 0), np.int64),
                    np.zeros((0, NUM_EDGE_FEATURES), np.float32))
        edges = {}
        for i in range(self.m):
            d = np.abs(self.log_norms - self.log_norms[i])
            d[i] = np.inf
            for j in np.argpartition(d, k)[:k]:
                key = (min(i, int(j)), max(i, int(j)))
                if key not in edges:
                    sim = 1.0 / (1.0 + d[j])
                    edges[key] = [
                        sim, sim, 0.0,
                        min(self.log_norms[i], self.log_norms[j]),
                        abs(self.log_norms[i] - self.log_norms[j]),
                    ]
        ei, ea = [], []
        for (i, j), f in edges.items():
            ei.extend([[i, j], [j, i]])
            ea.extend([f, f])
        return np.array(ei, np.int64).T, np.array(ea, np.float32)


def process_sdpa_to_graph(
    input_path: str,
    output_path: Optional[str] = None,
    max_neighbors: int = 15,
    similarity_threshold: float = 0.05,
    verbose: bool = False,
) -> Dict[str, np.ndarray]:
    """SDPA file -> graph feature dict (and optional .npz dump)."""
    C, A, b, m, n, offsets = _parse_for_features(input_path)
    ex = FeatureExtractor(C, A, b, m, n, offsets, verbose)
    g = ex.compute_global_features()
    x = ex.compute_node_features()
    ei, ea = ex.compute_edges(max_neighbors, similarity_threshold)

    if ei.shape[1] > 0:
        deg = np.bincount(ei[0], minlength=m)
        g[15] = deg.mean()
        g[16] = deg.std()
        x[:, 14] = np.log1p(deg)

    out = {
        "x": x, "edge_index": ei, "edge_attr": ea, "global_attr": g,
        "num_nodes": np.int64(m),
    }
    if output_path:
        d = os.path.dirname(output_path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez_compressed(output_path, **out)
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="SDPA -> graph features")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--max-neighbors", type=int, default=15)
    ap.add_argument("--similarity-threshold", type=float, default=0.05)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    process_sdpa_to_graph(
        args.input, args.output, args.max_neighbors,
        args.similarity_threshold, args.verbose,
    )


if __name__ == "__main__":
    main()
