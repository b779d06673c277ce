"""Synthetic problem generators (tests, smoke runs).

``random_maxcut_problem`` is a copy of the JAX package's generator, so both
packages build the same ``SDPProblem`` from the same seed.  It mirrors the
Julia data generator's construction (``lorads/data/gen_MaxCut.jl:213-243``):
objective = graph Laplacian scaled, constraints diag(X) = 1.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.spatial

from .io.sdpa import SDPAData, SDPABlock
from .problem import SDPProblem, canonicalize


def random_maxcut_problem(n: int, avg_degree: int = 6, seed: int = 0,
                          name: str = "synthetic_maxcut") -> SDPProblem:
    """MaxCut SDP on a random graph: min <-L/4, X>, diag(X) = 1, X >= 0."""
    rng = np.random.default_rng(seed)
    n_edges = n * avg_degree // 2
    u = rng.integers(0, n, size=n_edges)
    v = rng.integers(0, n, size=n_edges)
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    key = lo.astype(np.int64) * n + hi
    _, idx = np.unique(key, return_index=True)
    lo, hi = lo[idx], hi[idx]
    wts = np.ones(lo.size)

    deg = np.zeros(n)
    np.add.at(deg, lo, wts)
    np.add.at(deg, hi, wts)

    # C = -L/4 pre-negation; the reader negates objective entries, so build
    # the already-negated form directly: c = +L/4 off-diag -> stored C value
    c_rows = np.concatenate([np.arange(n), lo])
    c_cols = np.concatenate([np.arange(n), hi])
    c_vals = np.concatenate([-deg / 4.0, wts / 4.0])

    blk = SDPABlock(
        dim=n,
        c_rows=c_rows.astype(np.int32), c_cols=c_cols.astype(np.int32),
        c_vals=c_vals,
        a_rows=np.arange(n, dtype=np.int32),
        a_cols=np.arange(n, dtype=np.int32),
        a_vals=np.ones(n),
        a_cid=np.arange(n, dtype=np.int32),
    )
    data = SDPAData(n_constrs=n, blocks=[blk], b=np.ones(n))
    return canonicalize(data, name=name)


def delaunay_maxcut_adjacency(n: int, seed: int) -> scipy.sparse.csc_matrix:
    """Symmetric 0/1 adjacency of the Delaunay triangulation of ``n`` seeded
    uniform points in the unit square.

    The same construction as ``bench.py``'s ``_ensure_dn20``; at n = 2^14 the
    graph is of the kind of SuiteSparse ``delaunay_n14`` (about 3n edges,
    degree about 6), the LoRADS MaxCut row of ``bench.py``.
    """
    rng = np.random.default_rng(seed)
    tri = scipy.spatial.Delaunay(rng.random((n, 2)))
    s = tri.simplices
    e = np.vstack([s[:, [0, 1]], s[:, [1, 2]], s[:, [0, 2]]])
    lo, hi = e.min(1), e.max(1)
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    lo = (uniq // n).astype(np.int32)
    hi = (uniq % n).astype(np.int32)
    A = scipy.sparse.coo_matrix((np.ones(lo.size), (lo, hi)), shape=(n, n))
    return (A + A.T).tocsc()
