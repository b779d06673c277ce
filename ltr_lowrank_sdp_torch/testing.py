"""Synthetic problem generators (tests, smoke runs).

``random_maxcut_problem`` is a copy of the JAX package's generator, so both
packages build the same ``SDPProblem`` from the same seed.  It mirrors the
Julia data generator's construction (``lorads/data/gen_MaxCut.jl:213-243``):
objective = graph Laplacian scaled, constraints diag(X) = 1.

``matcomp_sdpa`` / ``matcomp_problem`` follow ``scripts/gen_instances.py``
``gen_matcomp`` (``lorads/data/gen_MatrixCompletion.jl:261-276``) draw for
draw, built in memory; ``write_sdpa`` writes the same instance as a
``.dat-s`` file that reads back to identical arrays.  ``random_sparse_cone``
follows the random cone of the JAX package's ``tests/test_coneops.py``.

``random_multiblock_problem`` is a copy of the JAX package's generator (the
same draws in the same order).  ``multiblock_lp_sdpa`` keeps its construction
(C_k = G G^T + I as a full upper triangle, three random entries per constraint
per block, b = A(X0) for a random PSD X0) at any size and adds an LP cone;
``theta_sdpa`` is ``scripts/gen_instances.py`` ``gen_theta`` (C all ones, one
trace constraint, one X_ij = 0 per edge) built as arrays.

``captured_kernel_nodes`` counts the device kernels that one call launches
on the card (the smoke run and the tests marked ``cuda``).  ``same_sdpa``
compares two readings of a file (either package's ``SDPAData``), array by
array; ``StubTrial`` answers an Optuna trial's calls from a table (``optuna``
is not a dependency).
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse
import scipy.spatial
import torch

from .io.sdpa import SDPAData, SDPABlock, _dedupe_sum, _postprocess
from .problem import ConeData, SDPProblem, canonicalize


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


def matcomp_sdpa(n1: int, n2: int, rank: int = 3, sample_factor: float = 2.0,
                 seed: int = 0) -> SDPAData:
    """Nuclear-norm matrix completion of a seeded rank-``rank`` (n1, n2)
    matrix M as an SDP on the embedding Y = [[W1, X], [X^T, W2]]:
    min tr(W1) + tr(W2) s.t. 2 Y[i, n1 + j] = 2 M_ij on the observed
    entries.  The same draws as ``scripts/gen_instances.py gen_matcomp``,
    passed through the SDPA reader's conventions (objective negated, upper
    triangle, sorted by constraint)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n1, rank))
    R = rng.normal(size=(n2, rank))
    n_obs = int(sample_factor * rank * (n1 + n2) * np.log(n1 + n2))
    n_obs = min(n_obs, n1 * n2)
    idx = rng.choice(n1 * n2, size=n_obs, replace=False)
    ii, jj = (idx // n2).astype(np.int64), (idx % n2).astype(np.int64)
    vals = np.einsum("ij,ij->i", L[ii], R[jj])
    n = n1 + n2
    # as written to a file: constraint 0 is the objective F0 = -I, which
    # the solver minimizes negated
    diag = np.arange(n, dtype=np.int64)
    cid = np.concatenate([np.zeros(n, np.int64), np.arange(1, n_obs + 1)])
    row = np.concatenate([diag, ii])
    col = np.concatenate([diag, n1 + jj])
    val = np.concatenate([-np.ones(n), np.ones(n_obs)])
    return _postprocess([n], 0, 2.0 * vals, cid, np.zeros_like(cid), row,
                        col, val)


def matcomp_nuclear_norm(n1: int, n2: int, rank: int = 3,
                         seed: int = 0) -> float:
    """||M||_* of the planted matrix M = L R^T of :func:`matcomp_sdpa` with
    the same seed (the trace of its optimal Y is 2 ||M||_* when the
    completion is exact), from the factors' (rank x rank) core."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n1, rank))
    R = rng.normal(size=(n2, rank))
    core = np.linalg.qr(L, mode="r") @ np.linalg.qr(R, mode="r").T
    return float(np.sum(np.linalg.svd(core, compute_uv=False)))


def matcomp_problem(n1: int, n2: int, rank: int = 3,
                    sample_factor: float = 2.0, seed: int = 0,
                    name: str = "synthetic_matcomp") -> SDPProblem:
    """:func:`matcomp_sdpa` canonicalized.  Below n1 + n2 of about 1000 the
    default sampling gives a union pattern dense enough to be classified
    ``dense``; ``rank=2, sample_factor=1.0`` keeps a small instance sparse."""
    return canonicalize(matcomp_sdpa(n1, n2, rank, sample_factor, seed),
                        name=name)


def write_sdpa(path, data: SDPAData) -> None:
    """Write the SDP blocks and, last, the LP block (as a block of negative
    dimension) in SDPA sparse format.  Objective values are negated back to
    the file's convention and every number is written with 17 significant
    digits, so :func:`..io.sdpa.read_sdpa` returns arrays identical to
    ``data`` (constraint entries in the reader's sorted order)."""
    dims = [str(d) for d in data.block_dims]
    if data.n_lp_cols:
        dims.append(str(-data.n_lp_cols))
    with open(path, "w") as f:
        f.write(f"{data.n_constrs}\n{len(dims)}\n")
        f.write(" ".join(dims) + "\n")
        f.write(" ".join(f"{x:.17g}" for x in data.b.tolist()) + "\n")
        for k, blk in enumerate(data.blocks, start=1):
            f.writelines(
                f"0 {k} {i + 1} {j + 1} {-v:.17g}\n" for i, j, v in zip(
                    blk.c_rows.tolist(), blk.c_cols.tolist(),
                    blk.c_vals.tolist()))
            f.writelines(
                f"{c + 1} {k} {i + 1} {j + 1} {v:.17g}\n" for c, i, j, v in
                zip(blk.a_cid.tolist(), blk.a_rows.tolist(),
                    blk.a_cols.tolist(), blk.a_vals.tolist()))
        if data.n_lp_cols:
            k = len(data.blocks) + 1
            f.writelines(
                f"0 {k} {j + 1} {j + 1} {-v:.17g}\n"
                for j, v in enumerate(data.lp_c.tolist()) if v != 0.0)
            f.writelines(
                f"{c + 1} {k} {j + 1} {j + 1} {v:.17g}\n" for c, j, v in
                zip(data.lp_cid.tolist(), data.lp_col.tolist(),
                    data.lp_vals.tolist()))


def random_multiblock_problem(dims=(14, 14, 10), m=12, seed=23,
                              name="synthetic_multiblock") -> SDPProblem:
    """Bounded, strictly feasible multi-block SDP (a copy of the JAX
    package's generator).

    C_k is PSD (G G^T + I) so min <C, X> over X >= 0 is bounded below;
    b = A(X0) for random PSD X0 makes the problem strictly feasible.
    Blocks couple through the shared constraint space (every constraint
    touches every block): the stress case for the Gauss-Seidel and Jacobi
    ADMM sweeps.
    """
    rng = np.random.default_rng(seed)
    blocks = []
    for n in dims:
        G = rng.normal(size=(n, 3)) / np.sqrt(n)
        C = G @ G.T + np.eye(n)
        iu = np.triu_indices(n)
        c_rows, c_cols, c_vals = iu[0], iu[1], C[iu]
        rows, cols, vals, cids = [], [], [], []
        for i in range(m):
            for _ in range(3):
                r = int(rng.integers(0, n))
                c = int(rng.integers(r, n))
                rows.append(r)
                cols.append(c)
                vals.append(float(rng.normal()))
                cids.append(i)
        blocks.append(SDPABlock(
            dim=n,
            c_rows=c_rows.astype(np.int32), c_cols=c_cols.astype(np.int32),
            c_vals=c_vals,
            a_rows=np.array(rows, np.int32), a_cols=np.array(cols, np.int32),
            a_vals=np.array(vals), a_cid=np.array(cids, np.int32)))
    prob0 = canonicalize(SDPAData(n_constrs=m, blocks=blocks, b=np.zeros(m)))
    b = np.zeros(m)
    for cone in prob0.cones:
        F = rng.normal(size=(cone.n, 4))
        X0 = F @ F.T / 4.0
        A = dense_constraint_matrices(cone)
        b += np.einsum("mij,ij->m", A, X0)
    return canonicalize(SDPAData(n_constrs=m, blocks=blocks, b=b),
                        name=name)


def multiblock_lp_sdpa(dims=(100, 80, 60), m: int = 240, n_lp: int = 2000,
                       seed: int = 0) -> SDPAData:
    """Bounded, strictly feasible multi-block SDP with an LP cone, in the
    construction of :func:`random_multiblock_problem` at any size.

    Per block: C_k = G G^T + I with G of shape (n, 3) / sqrt(n), written as
    a full upper triangle (so every block is classified dense), and three
    random upper-triangle entries per constraint, every constraint touching
    every block.  The LP cone has ``n_lp`` columns, each with a cost drawn
    from U(0.5, 1.5) and N(0, 1) entries in three random constraints.
    b = A(X0) + A_lp x0 for random PSD X0_k = F F^T / 4 and x0 ~ U(0.5,
    1.5), computed by a sparse contraction: the problem is strictly feasible
    and bounded below by 0."""
    rng = np.random.default_rng(seed)
    blocks = []
    b = np.zeros(m)
    for n in dims:
        G = rng.normal(size=(n, 3)) / np.sqrt(n)
        C = G @ G.T + np.eye(n)
        iu = np.triu_indices(n)
        rows = rng.integers(0, n, size=3 * m)
        cols = rng.integers(rows, n)
        vals = rng.normal(size=3 * m)
        cid = np.repeat(np.arange(m), 3)
        F = rng.normal(size=(n, 4))
        # <A_i, X0> with X0 = F F^T / 4: off-diagonal entries count twice
        x0 = np.einsum("ij,ij->i", F[rows], F[cols]) / 4.0
        np.add.at(b, cid, np.where(rows != cols, 2.0, 1.0) * vals * x0)
        # the reader's order and duplicate handling: sorted by (constraint,
        # row, col), equal positions summed
        a_rows, a_cols, a_vals, a_cid = _dedupe_sum(
            rows.astype(np.int32), cols.astype(np.int32), vals,
            extra=cid.astype(np.int32))
        blocks.append(SDPABlock(
            dim=n, c_rows=iu[0].astype(np.int32),
            c_cols=iu[1].astype(np.int32), c_vals=C[iu],
            a_rows=a_rows, a_cols=a_cols, a_vals=a_vals,
            a_cid=a_cid.astype(np.int32)))
    data = SDPAData(n_constrs=m, blocks=blocks, b=b)
    if n_lp:
        lp_c = rng.uniform(0.5, 1.5, size=n_lp)
        lp_col = np.repeat(np.arange(n_lp), 3)
        lp_cid = rng.integers(0, m, size=3 * n_lp)
        lp_vals = rng.normal(size=3 * n_lp)
        x0 = rng.uniform(0.5, 1.5, size=n_lp)
        np.add.at(b, lp_cid, lp_vals * x0[lp_col])
        # the reader keeps LP entries in file order; write_sdpa writes them
        # as they stand here
        data.n_lp_cols = n_lp
        data.lp_c = lp_c
        data.lp_col = lp_col.astype(np.int32)
        data.lp_cid = lp_cid.astype(np.int32)
        data.lp_vals = lp_vals
    return data


def multiblock_lp_problem(dims=(100, 80, 60), m: int = 240, n_lp: int = 2000,
                          seed: int = 0,
                          name: str = "synthetic_multiblock_lp") -> SDPProblem:
    """:func:`multiblock_lp_sdpa` canonicalized."""
    return canonicalize(multiblock_lp_sdpa(dims, m, n_lp, seed), name=name)


def theta_sdpa(n: int, avg_degree: int, seed: int,
               relabel: int = 0) -> SDPAData:
    """Lovasz theta SDP of a random G(n, avg_degree) graph: max <J, X> s.t.
    tr X = 1, X_ij = 0 for every edge, X >= 0.  The draws of
    ``scripts/gen_instances.py`` ``gen_theta``, passed through the SDPA
    reader's conventions: the objective is the full upper triangle of J,
    negated (the solver minimizes), constraint 0 is the trace and constraint
    1 + k the k-th edge.

    ``relabel`` > 0 renames the vertices by the permutation
    ``default_rng(relabel).permutation(n)`` after the draws (constraint k
    keeps its edge): the same SDP, its sums taken in another order."""
    rng = np.random.default_rng(seed)
    m_edges = n * avg_degree // 2
    u = rng.integers(0, n, size=m_edges)
    v = rng.integers(0, n, size=m_edges)
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = uniq // n, uniq % n
    if relabel:
        perm = np.random.default_rng(relabel).permutation(n)
        lo, hi = (np.minimum(perm[lo], perm[hi]),
                  np.maximum(perm[lo], perm[hi]))
    iu = np.triu_indices(n)
    diag = np.arange(n, dtype=np.int64)
    n_obj, n_e = iu[0].size, lo.size
    cid = np.concatenate([np.zeros(n_obj, np.int64), np.ones(n, np.int64),
                          np.arange(2, n_e + 2)])
    row = np.concatenate([iu[0], diag, lo])
    col = np.concatenate([iu[1], diag, hi])
    b = np.concatenate([[1.0], np.zeros(n_e)])
    return _postprocess([n], 0, b, cid, np.zeros_like(cid), row, col,
                        np.ones(cid.size))


def theta_problem(n: int, avg_degree: int, seed: int,
                  name: str = "synthetic_theta") -> SDPProblem:
    """:func:`theta_sdpa` canonicalized."""
    return canonicalize(theta_sdpa(n, avg_degree, seed), name=name)


def random_sparse_cone(rng: np.random.Generator, n: int, m: int,
                       nnz_per: int = 3, diag_only: bool = False,
                       force_kind=None) -> SDPProblem:
    """A single-block problem with ``nnz_per`` random upper-triangle entries
    per constraint (all on the diagonal with ``diag_only``) and 2n random
    objective entries; the draws of ``random_cone`` in the JAX package's
    ``tests/test_coneops.py``.  ``force_kind`` overrides the cone's
    ``kind_a`` (a small random cone is classified dense by its sparsity
    ratio), and with it the objective's kind for a forced ``sparse``."""
    rows, cols, vals, cids = [], [], [], []
    for i in range(m):
        for _ in range(nnz_per):
            r = rng.integers(0, n)
            c = rng.integers(r, n) if not diag_only else r
            rows.append(r)
            cols.append(c)
            vals.append(rng.normal())
            cids.append(i)
    c_rows = rng.integers(0, n, size=2 * n)
    c_cols = np.maximum(c_rows, rng.integers(0, n, size=2 * n))
    c_vals = rng.normal(size=2 * n)
    blk = SDPABlock(
        dim=n,
        c_rows=c_rows.astype(np.int32), c_cols=c_cols.astype(np.int32),
        c_vals=c_vals,
        a_rows=np.array(rows, np.int32), a_cols=np.array(cols, np.int32),
        a_vals=np.array(vals), a_cid=np.array(cids, np.int32),
    )
    prob = canonicalize(SDPAData(n_constrs=m, blocks=[blk],
                                 b=rng.normal(size=m)))
    if force_kind:
        prob.cones[0].kind_a = force_kind
        if force_kind == "sparse":
            prob.cones[0].kind_c = "sparse"
    return prob


def dense_constraint_matrices(cone: ConeData) -> np.ndarray:
    """(m, n, n) dense symmetric stack of a cone's A_i (small tests only)."""
    A = np.zeros((cone.m, cone.n, cone.n))
    np.add.at(A, (cone.a_cid, cone.a_rows, cone.a_cols), cone.a_vals)
    off = cone.a_rows != cone.a_cols
    np.add.at(A, (cone.a_cid[off], cone.a_cols[off], cone.a_rows[off]),
              cone.a_vals[off])
    return A


def dense_objective_matrix(cone: ConeData) -> np.ndarray:
    """(n, n) dense symmetric C of a cone (small tests only)."""
    C = np.zeros((cone.n, cone.n))
    np.add.at(C, (cone.c_rows, cone.c_cols), cone.c_vals)
    off = cone.c_rows != cone.c_cols
    np.add.at(C, (cone.c_cols[off], cone.c_rows[off]), cone.c_vals[off])
    return C


def captured_kernel_nodes(fn) -> int:
    """The device kernels one ``fn()`` launches, exactly: the nodes of a
    CUDA graph captured from one call on a side stream (warmed up there
    first), read through libcuda (cuGraphGetNodes).  Raises if the graph
    holds a node other than a kernel (a copy, a memset)."""
    cu = ctypes.CDLL("libcuda.so.1")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph, handle = ctypes.c_void_p(), ctypes.c_void_p(side.cuda_stream)
    with torch.cuda.stream(side):
        # CU_STREAM_CAPTURE_MODE_RELAXED: the caching allocator may run
        if cu.cuStreamBeginCapture_v2(handle, 2) != 0:
            raise RuntimeError("cuStreamBeginCapture failed")
        try:
            fn()
        finally:
            if cu.cuStreamEndCapture(handle, ctypes.byref(graph)) != 0:
                raise RuntimeError("cuStreamEndCapture failed")
    try:
        count = ctypes.c_size_t(0)
        cu.cuGraphGetNodes(graph, None, ctypes.byref(count))
        nodes = (ctypes.c_void_p * max(1, count.value))()
        cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count))
        kinds = []
        for i in range(count.value):
            t = ctypes.c_int(-1)
            cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(t))
            kinds.append(t.value)
    finally:
        cu.cuGraphDestroy(graph)
    if any(t != 0 for t in kinds):           # CU_GRAPH_NODE_TYPE_KERNEL
        raise RuntimeError(f"a captured call holds other nodes: {kinds}")
    return len(kinds)


def same_sdpa(a, b) -> bool:
    """Two ``SDPAData`` (either package's) with the same sizes and the same
    arrays, dtypes included."""
    def arrays(d):
        out = [d.b]
        for blk in d.blocks:
            out += [blk.c_rows, blk.c_cols, blk.c_vals, blk.a_rows,
                    blk.a_cols, blk.a_vals, blk.a_cid]
        return out + [getattr(d, f) for f in ("lp_c", "lp_col", "lp_cid",
                                              "lp_vals")]

    xs, ys = arrays(a), arrays(b)
    return ((a.n_constrs, tuple(a.block_dims), a.n_lp_cols)
            == (b.n_constrs, tuple(b.block_dims), b.n_lp_cols)
            and len(xs) == len(ys)
            and all((x is None and y is None) or (
                x is not None and y is not None
                and np.asarray(x).dtype == np.asarray(y).dtype
                and np.array_equal(x, y)) for x, y in zip(xs, ys)))


class StubTrial:
    """The calls the tuner's ``objective`` makes of an Optuna trial,
    answered from a table of values; ``report`` keeps each epoch's value,
    ``should_prune`` is false."""

    def __init__(self, values):
        self.values, self.reports = values, []

    def suggest_int(self, name, low, high, step=1):
        assert low <= self.values[name] <= high, name
        return self.values[name]

    def suggest_float(self, name, low, high, log=False):
        return self.values[name]

    def suggest_categorical(self, name, choices):
        assert self.values[name] in choices, name
        return self.values[name]

    def report(self, value, step):
        self.reports.append((step, value))

    def should_prune(self):
        return False
