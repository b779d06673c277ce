"""The eight CUDA kernels of the port against their plain PyTorch versions,
on the GPU.  Those tests are marked ``cuda``: they build the kernels with
nvcc and skip on a machine without a GPU.  Run them there with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the port's GPU
machine need not have; this file imports none of it.)

The plain versions of K5 to K8 and the host-built layouts they share with
the kernels (K5's long-segment chunks included) are held against a dense
numpy evaluation on the CPU (unmarked tests; K1-K4's are in
``test_torch_isolation.py``, K7 and K8 against the JAX package's ``LPOps``
in ``test_torch_coneops.py``).

Tolerance: 1e-12 relative in the 2-norm (float64; the kernels sum in
another order than the plain versions).
"""

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.testing import delaunay_maxcut_adjacency

cuda = pytest.mark.cuda

RTOL = 1e-12


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    K.build_kernels()
    return torch.device("cuda", torch.cuda.current_device())


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _upper(n, seed):
    A = delaunay_maxcut_adjacency(n, seed).tocoo()
    keep = A.row < A.col
    rows = np.concatenate([np.arange(n), A.row[keep]])
    cols = np.concatenate([np.arange(n), A.col[keep]])
    vals = np.random.default_rng(seed).standard_normal(rows.size)
    return rows, cols, vals


@cuda
@pytest.mark.parametrize("n,r", [(1000, 20), (777, 64), (333, 1), (129, 33)])
def test_spmm_sym_csr(dev, n, r):
    rows, cols, vals = _upper(n, 1)
    csr = K.SymCSR.from_upper_coo(rows, cols, vals, n, dev)
    g = torch.Generator(device=dev).manual_seed(n)
    Y = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
    d = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    before = K.KERNELS["spmm_sym_csr"].launches
    for args in ((csr, Y, 0.7, d), (csr, Y, 1.0, None), (None, Y, 0.0, d)):
        got = K.spmm_sym_csr(*args)
        torch.cuda.synchronize()
        assert _rel(got, K.spmm_sym_csr_plain(*args)) <= RTOL
    assert K.KERNELS["spmm_sym_csr"].launches == before + 3


@cuda
@pytest.mark.parametrize("n,r", [(1000, 20), (777, 64), (129, 33)])
def test_diag_rowdot(dev, n, r):
    g = torch.Generator(device=dev).manual_seed(n)
    U, V = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    dv = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    assert _rel(K.diag_rowdot(U, V, dv, 1.0),
                K.diag_rowdot_plain(U, V, dv, 1.0)) <= RTOL
    o1, o2 = K.diag_rowdot(U, V, dv, 2.0, second=True)
    p1, p2 = K.diag_rowdot_plain(U, V, dv, 2.0, second=True)
    assert _rel(o1, p1) <= RTOL and _rel(o2, p2) <= RTOL


@cuda
@pytest.mark.parametrize("n,r", [(1000, 20), (777, 64), (129, 33)])
def test_diag_normal_matvec(dev, n, r):
    g = torch.Generator(device=dev).manual_seed(n)
    x, F = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    dv = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    assert _rel(K.diag_normal_matvec(x, F, dv),
                K.diag_normal_matvec_plain(x, F, dv)) <= RTOL


@cuda
@pytest.mark.parametrize("n,r", [(1000, 20), (777, 64), (129, 33)])
def test_sym_contract_sum(dev, n, r):
    rows, cols, vals = _upper(n, 2)
    coef = np.where(rows != cols, 2.0 * vals, vals)
    rt = torch.tensor(rows, dtype=torch.int32, device=dev)
    ct = torch.tensor(cols, dtype=torch.int32, device=dev)
    cf = torch.tensor(coef, dtype=torch.float64, device=dev)
    g = torch.Generator(device=dev).manual_seed(n)
    U, V = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    for a, b in ((U, V), (U, U)):
        got = K.sym_contract_sum(rt, ct, cf, a, b)
        want = K.sym_contract_sum_plain(rt, ct, cf, a, b)
        assert abs(float(got) - float(want)) <= RTOL * abs(float(want))
        # no atomics: the same bits on every run
        assert float(K.sym_contract_sum(rt, ct, cf, a, b)) == float(got)


@cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    n, r = 64, 8
    Y = torch.zeros((n, r), dtype=torch.float64, device=dev)
    dv = torch.ones(n, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        K.diag_normal_matvec(Y.float(), Y.float(), dv)
    with pytest.raises(ValueError, match="contiguous"):
        K.diag_rowdot(Y.t().contiguous().t(), Y, dv)
    with pytest.raises(ValueError, match="shape"):
        K.diag_normal_matvec(Y, Y[:, :4].contiguous(), dv)
    with pytest.raises(ValueError):
        K.diag_rowdot(Y, Y.cpu(), dv)


# --------------------------------------------------------------------------- #
# K5 coo_contract_segsum and K6 spmm_constr_csr
# --------------------------------------------------------------------------- #


def _constraint_entries(case, seed=0):
    """(n, m, rows, cols, vals, cid): upper-triangle entries of m constraint
    matrices.  Every case leaves constraint 1 without entries."""
    rng = np.random.default_rng(seed)
    if case == "several":       # 5 entries per constraint, repeats included
        n, m, per = 150, 60, 5
        cid = np.repeat(np.arange(m), per)
        rows = rng.integers(0, n, cid.size)
        cols = np.array([rng.integers(r, n) for r in rows])
        rows[:4], cols[:4] = 3, (3, 9, 9, 20)    # one constraint, one row
    elif case == "matcomp":     # one off-diagonal entry per constraint
        n, m = 200, 900
        cid = np.arange(m)
        rows = rng.integers(0, n // 2, m)
        cols = n // 2 + rng.integers(0, n // 2, m)
    elif case == "diag":        # diagonal entries only, 2 rows share a cid
        n, m = 120, 180
        cid = np.concatenate([np.arange(m), [7]])
        rows = cols = rng.integers(0, n, m + 1)
    elif case == "trace":       # a trace-like constraint of n entries
        n, m = 300, 40
        cid = np.concatenate([np.zeros(n, int), rng.integers(2, m, 200)])
        rows = np.concatenate([np.arange(n), rng.integers(0, n, 200)])
        cols = np.concatenate([np.arange(n), rng.integers(0, n, 200)])
        rows, cols = np.minimum(rows, cols), np.maximum(rows, cols)
    elif case == "theta":       # a 600-entry trace segment + one per edge
        n, m = 600, 400
        cid = np.concatenate([np.zeros(n, int), np.arange(2, m)])
        rows = np.concatenate([np.arange(n), rng.integers(0, n - 1, m - 2)])
        cols = np.concatenate([np.arange(n),
                               rows[n:] + 1 + rng.integers(0, 5, m - 2)])
        cols = np.minimum(cols, n - 1)
    elif case == "long":        # segments of 31, 32, 33 and 200 entries
        n, m = 90, 8
        cid = np.repeat([0, 2, 3, 5], [31, 32, 33, 200])
        rows = rng.integers(0, n, cid.size)
        cols = np.array([rng.integers(r, n) for r in rows])
    else:
        raise AssertionError(case)
    keep = cid != 1
    rows, cols, cid = rows[keep], cols[keep], cid[keep]
    return n, m, rows, cols, rng.standard_normal(rows.size), cid


CASES = ["several", "matcomp", "diag", "trace", "theta", "long"]


def _dense_stack(n, m, rows, cols, vals, cid):
    A = np.zeros((m, n, n))
    np.add.at(A, (cid, rows, cols), vals)
    off = rows != cols
    np.add.at(A, (cid[off], cols[off], rows[off]), vals[off])
    return A


@pytest.mark.parametrize("r", [1, 6])
@pytest.mark.parametrize("case", CASES)
def test_k5_k6_plain_match_dense_numpy(case, r):
    n, m, rows, cols, vals, cid = _constraint_entries(case)
    A = _dense_stack(n, m, rows, cols, vals, cid)
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, "cpu")
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, "cpu")
    assert seg.nnz == rows.size
    assert csr.nnz == 2 * rows.size - int(np.sum(rows == cols))
    assert int(seg.seg_ptr[2] - seg.seg_ptr[1]) == 0
    rng = np.random.default_rng(1)
    U, V, Z = (rng.standard_normal((n, r)) for _ in range(3))
    w = rng.standard_normal(m)
    Ut, Vt, Zt, wt = (torch.tensor(x) for x in (U, V, Z, w))
    tol = dict(rtol=1e-12, atol=1e-12)
    K.reset_counts()
    sym = 0.5 * (U @ V.T + V @ U.T)
    got = K.coo_contract_segsum(seg, Ut, Vt)
    np.testing.assert_allclose(got, np.einsum("mij,ij->m", A, sym), **tol)
    assert got[1] == 0.0
    np.testing.assert_allclose(K.coo_contract_segsum(seg, Ut, Ut),
                               np.einsum("mij,ij->m", A, U @ U.T), **tol)
    o1, o2 = K.coo_contract_segsum(seg, Ut, Vt, pair=True)
    np.testing.assert_allclose(o1, np.einsum("mij,ij->m", A, 2 * sym), **tol)
    np.testing.assert_allclose(o2, np.einsum("mij,ij->m", A, V @ V.T), **tol)
    S = np.einsum("m,mij->ij", w, A)
    np.testing.assert_allclose(K.spmm_constr_csr(csr, wt, Ut), S @ U, **tol)
    np.testing.assert_allclose(K.spmm_constr_csr(csr, wt, Ut, Z=Zt, beta=0.5),
                               0.5 * Z + S @ U, **tol)
    assert K.counts()["coo_contract_segsum"] == (0, 3)
    assert K.counts()["spmm_constr_csr"] == (0, 2)


@cuda
@pytest.mark.parametrize("r", [1, 19, 33, 64])
@pytest.mark.parametrize("case", CASES)
def test_coo_contract_segsum(dev, case, r):
    n, m, rows, cols, vals, cid = _constraint_entries(case)
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev)
    g = torch.Generator(device=dev).manual_seed(r)
    U, V = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    before = K.KERNELS["coo_contract_segsum"].launches
    for a, b in ((U, V), (U, U)):
        got = K.coo_contract_segsum(seg, a, b)
        torch.cuda.synchronize()
        assert _rel(got, K.coo_contract_segsum_plain(seg, a, b)) <= RTOL
        assert float(got[1]) == 0.0          # a constraint without entries
        # no atomics: the same bits on every run
        assert torch.equal(K.coo_contract_segsum(seg, a, b), got)
    o1, o2 = K.coo_contract_segsum(seg, U, V, pair=True)
    p1, p2 = K.coo_contract_segsum_plain(seg, U, V, pair=True)
    assert _rel(o1, p1) <= RTOL and _rel(o2, p2) <= RTOL
    assert K.KERNELS["coo_contract_segsum"].launches == before + 5


@cuda
@pytest.mark.parametrize("r", [1, 19, 33, 64])
@pytest.mark.parametrize("case", CASES)
def test_spmm_constr_csr(dev, case, r):
    n, m, rows, cols, vals, cid = _constraint_entries(case)
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, dev)
    g = torch.Generator(device=dev).manual_seed(r)
    Y, Z = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    w = torch.randn(m, generator=g, dtype=torch.float64, device=dev)
    w0 = torch.where(torch.arange(m, device=dev) % 3 == 0, 0.0, w)
    before = K.KERNELS["spmm_constr_csr"].launches
    for args in ((csr, w, Y), (csr, w, Y, Z, 1.0), (csr, w0, Y, Z, -0.25)):
        got = K.spmm_constr_csr(*args)
        torch.cuda.synchronize()
        assert _rel(got, K.spmm_constr_csr_plain(*args)) <= RTOL
        assert torch.equal(K.spmm_constr_csr(*args), got)
    assert K.KERNELS["spmm_constr_csr"].launches == before + 6


@cuda
def test_normal_matvec_is_k5_then_k6(dev):
    """x + A*(A(sym(x F^T))) F through the two kernels against the plain
    versions."""
    n, m, rows, cols, vals, cid = _constraint_entries("matcomp")
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev)
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x, F = (torch.randn((n, 19), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    got = K.spmm_constr_csr(csr, K.coo_contract_segsum(seg, x, F), F, Z=x)
    want = K.spmm_constr_csr_plain(
        csr, K.coo_contract_segsum_plain(seg, x, F), F, Z=x)
    assert _rel(got, want) <= RTOL


@cuda
def test_general_wrappers_reject_what_the_kernels_do_not_take(dev):
    n, m, rows, cols, vals, cid = _constraint_entries("several")
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev)
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, dev)
    Y = torch.zeros((n, 8), dtype=torch.float64, device=dev)
    w = torch.zeros(m, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        K.coo_contract_segsum(seg, Y.float(), Y.float())
    with pytest.raises(ValueError, match="rows"):
        K.coo_contract_segsum(seg, Y[:-1].contiguous(), Y[:-1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        K.spmm_constr_csr(csr, w[:-1].contiguous(), Y)
    with pytest.raises(ValueError, match="contiguous"):
        K.spmm_constr_csr(csr, w, Y.t().contiguous().t())
    with pytest.raises(ValueError):
        K.spmm_constr_csr(csr, w, Y, Z=Y.cpu())


def test_int32_guard_of_the_layouts():
    with pytest.raises(ValueError, match="int32"):
        K._i32(2**31, "nnz of A")
    with pytest.raises(ValueError, match="int32"):
        K.SegCOO.from_coo([0], [0], [1.0], [0], 2**31, 1, "cpu")


def test_k5_layout_cuts_long_segments_into_ordered_chunks():
    """Segments of at least ``K5_LONG_SEGMENT`` entries are cut into chunks
    of at most ``K5_CHUNK`` that tile them in order; shorter ones are not."""
    n, m, rows, cols, vals, cid = _constraint_entries("long")
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, "cpu")
    assert (K.K5_LONG_SEGMENT, K.K5_CHUNK) == (32, 8)
    assert seg.long_seg.tolist() == [2, 3, 5]          # 31 entries stay whole
    assert seg.long_ptr.tolist() == [0, 4, 9, 34]
    ptr = seg.seg_ptr.tolist()
    chunks = seg.chunk_ptr.tolist()
    for l, s_id in enumerate(seg.long_seg.tolist()):
        mine = chunks[seg.long_ptr[l]: seg.long_ptr[l + 1]]
        assert mine[0][0] == ptr[s_id] and mine[-1][1] == ptr[s_id + 1]
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert all(0 < e - st <= K.K5_CHUNK for st, e in mine)
    theta = K.SegCOO.from_coo(*_constraint_entries("theta")[2:], 600, 400,
                              "cpu")
    assert theta.long_seg.tolist() == [0] and theta.n_chunks == 75
    whole = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, "cpu",
                              long_thresh=None)
    assert whole.n_chunks == 0 and whole.long_seg is None
    short = K.SegCOO.from_coo(*_constraint_entries("several")[2:], 150, 60,
                              "cpu")
    assert short.n_chunks == 0 and short.chunk_ptr is None


@cuda
@pytest.mark.parametrize("r", [1, 13, 64])
@pytest.mark.parametrize("case", ["trace", "theta", "long"])
def test_k5_long_segment_split_is_deterministic(dev, case, r):
    """With and without the split: the same values to 1e-12, and the same
    bits on repeated calls in all three modes."""
    n, m, rows, cols, vals, cid = _constraint_entries(case)
    split = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev)
    whole = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev,
                              long_thresh=None)
    assert split.n_chunks > 0 and whole.n_chunks == 0
    g = torch.Generator(device=dev).manual_seed(r)
    U, V = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    for a, b, pair in ((U, V, False), (U, U, False), (U, V, True)):
        got = K.coo_contract_segsum(split, a, b, pair=pair)
        ref = K.coo_contract_segsum(whole, a, b, pair=pair)
        again = K.coo_contract_segsum(split, a, b, pair=pair)
        torch.cuda.synchronize()
        for x, y, z in zip(*(t if pair else (t,) for t in (got, ref, again))):
            assert _rel(x, y) <= RTOL
            assert torch.equal(x, z)
            assert float(x[1]) == 0.0


# --------------------------------------------------------------------------- #
# K7 lp_constr_segsum and K8 lp_col_wsum
# --------------------------------------------------------------------------- #


def _lp_entries(case, seed=0):
    """(m, n_cols, c, col, cid, vals) of an LP cone.  Every case leaves
    constraint 1 and the last column without entries."""
    rng = np.random.default_rng(seed)
    if case == "three":          # three random constraints per column
        m, n_cols = 240, 2000
        col = np.repeat(np.arange(n_cols - 1), 3)
        cid = rng.integers(0, m, col.size)
    elif case == "slack":        # one entry per column
        m, n_cols = 500, 300
        col = np.arange(n_cols - 1)
        cid = rng.integers(0, m, col.size)
    elif case == "wide":         # one constraint over every column, repeats
        m, n_cols = 12, 700
        col = np.concatenate([np.arange(n_cols - 1),
                              rng.integers(0, n_cols - 1, 900)])
        cid = np.concatenate([np.zeros(n_cols - 1, int),
                              rng.integers(0, m, 900)])
    else:
        raise AssertionError(case)
    keep = cid != 1
    col, cid = col[keep], cid[keep]
    order = rng.permutation(col.size)          # the file's order is any
    col, cid = col[order], cid[order]
    return (m, n_cols, rng.uniform(0.5, 1.5, n_cols), col, cid,
            rng.standard_normal(col.size))


LP_CASES = ["three", "slack", "wide"]


@pytest.mark.parametrize("case", LP_CASES)
def test_k7_k8_plain_match_numpy(case):
    m, n_cols, c, col, cid, vals = _lp_entries(case)
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, "cpu")
    assert lp.nnz == col.size
    assert int(lp.row_ptr[2] - lp.row_ptr[1]) == 0
    assert int(lp.col_ptr[-1] - lp.col_ptr[-2]) == 0
    rng = np.random.default_rng(1)
    u, v = rng.standard_normal(n_cols), rng.standard_normal(n_cols)
    w = rng.standard_normal(m)
    ut, vt, wt = torch.tensor(u), torch.tensor(v), torch.tensor(w)
    A = np.zeros((m, n_cols))
    np.add.at(A, (cid, col), vals)
    tol = dict(rtol=1e-12, atol=1e-12)
    K.reset_counts()
    got = K.lp_constr_segsum(lp, ut, vt)
    np.testing.assert_allclose(got, A @ (u * v), **tol)
    assert got[1] == 0.0
    q1, q2 = K.lp_constr_segsum(lp, ut, vt, pair=True)
    np.testing.assert_allclose(q1, 2.0 * (A @ (u * v)), **tol)
    np.testing.assert_allclose(q2, A @ (v * v), **tol)
    got = K.lp_col_wsum(lp, wt, 2.5)
    np.testing.assert_allclose(got, 2.5 * c + A.T @ w, **tol)
    assert got[-1] == 2.5 * c[-1]
    np.testing.assert_allclose(K.lp_col_wsum(lp, wt, 0.0), A.T @ w, **tol)
    assert K.counts()["lp_constr_segsum"] == (0, 2)
    assert K.counts()["lp_col_wsum"] == (0, 2)


@cuda
@pytest.mark.parametrize("case", LP_CASES)
def test_lp_constr_segsum(dev, case):
    m, n_cols, c, col, cid, vals = _lp_entries(case)
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, dev)
    g = torch.Generator(device=dev).manual_seed(m)
    u, v = (torch.randn(n_cols, generator=g, dtype=torch.float64, device=dev)
            for _ in range(2))
    before = K.KERNELS["lp_constr_segsum"].launches
    got = K.lp_constr_segsum(lp, u, v)
    torch.cuda.synchronize()
    assert _rel(got, K.lp_constr_segsum_plain(lp, u, v)) <= RTOL
    assert float(got[1]) == 0.0              # a constraint without entries
    assert torch.equal(K.lp_constr_segsum(lp, u, v), got)
    q1, q2 = K.lp_constr_segsum(lp, u, v, pair=True)
    p1, p2 = K.lp_constr_segsum_plain(lp, u, v, pair=True)
    assert _rel(q1, p1) <= RTOL and _rel(q2, p2) <= RTOL
    same = K.lp_constr_segsum(lp, v, v)
    assert _rel(q2, same) <= RTOL
    assert K.KERNELS["lp_constr_segsum"].launches == before + 4


@cuda
@pytest.mark.parametrize("case", LP_CASES)
def test_lp_col_wsum(dev, case):
    m, n_cols, c, col, cid, vals = _lp_entries(case)
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, dev)
    g = torch.Generator(device=dev).manual_seed(m)
    w = torch.randn(m, generator=g, dtype=torch.float64, device=dev)
    before = K.KERNELS["lp_col_wsum"].launches
    for c0 in (1.0, 5.0, 0.0):
        got = K.lp_col_wsum(lp, w, c0)
        torch.cuda.synchronize()
        assert _rel(got, K.lp_col_wsum_plain(lp, w, c0)) <= RTOL
        assert float(got[-1]) == c0 * float(lp.c[-1])   # a column, no entry
        assert torch.equal(K.lp_col_wsum(lp, w, c0), got)
    assert K.KERNELS["lp_col_wsum"].launches == before + 6


@cuda
def test_lp_wrappers_reject_what_the_kernels_do_not_take(dev):
    m, n_cols, c, col, cid, vals = _lp_entries("three")
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, dev)
    u = torch.zeros(n_cols, dtype=torch.float64, device=dev)
    w = torch.zeros(m, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        K.lp_constr_segsum(lp, u.float(), u.float())
    with pytest.raises(ValueError, match="shape"):
        K.lp_constr_segsum(lp, u[:-1].contiguous(), u[:-1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        K.lp_col_wsum(lp, w[:-1].contiguous())
    with pytest.raises(ValueError):
        K.lp_constr_segsum(lp, u, u.cpu())
