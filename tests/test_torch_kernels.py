"""The thirteen CUDA kernels of the port against their plain PyTorch versions,
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
another order than the plain versions); K9 and K10, which run in float32,
max |kernel - plain| / max |plain| <= 1e-5 against the plain version
evaluated in float64 on the same inputs (the plain version in float32 sums a
segment with ``index_add_`` into one accumulator: over the 85,080 nodes of
one graph that alone is 7e-5 off).  Their backward kernels K11 and K12 are
held the same way, output by output, against the plain backward evaluated
in float64 on the kernel's own inputs (K9's lse and out, K10's out, stats and
tie counts included), with and without dropout keep-scales and with tied
maxima, each output's scale floored at 1e-6 of the largest output (an output
whose exact value vanishes is rounding); the plain backwards themselves pass
``torch.autograd.gradcheck`` in float64 on the CPU (unmarked tests).
K13 (``gather_rowsum``, float32) is held like K9: against its plain version
evaluated in float64, max |kernel - plain| / max |plain| <= 1e-5, at the
gather probe's shape and at widths and index counts that leave partial
tiles, lanes and warps; its plain version against the Pallas ``kern`` it
replaces is in ``test_torch_gather_probe.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.scripts.gather_probe import probe_inputs
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


K7_SIZES = (0, 1, 7, 31, 32, 33, 1000)    # entries of a constraint


def _k7_layout(dtype, dev, seed=5):
    """An LP cone whose constraints have every size of ``K7_SIZES`` (a
    round of 32 entries, part of one, several), each size 9 times in a
    shuffled order of constraints and of entries."""
    rng = np.random.default_rng(seed)
    n_cols = 3000
    sizes = rng.permutation(np.repeat(K7_SIZES, 9))
    cid = np.repeat(np.arange(sizes.size), sizes)
    col = rng.integers(0, n_cols, cid.size)
    order = rng.permutation(cid.size)
    lp = K.LPEntries.from_coo(np.ones(n_cols), col[order], cid[order],
                              rng.standard_normal(cid.size), sizes.size,
                              n_cols, dev, dtype)
    return lp, sizes


@cuda
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k7_gives_the_bits_of_its_plain_order(dev, dtype, pair):
    """K7 gives the bits of a second call and of its order in plain PyTorch
    (``lp_constr_segsum_order``, the same products and sums one rounding
    each); the result matches the plain version (float64: 1e-12 in the
    2-norm; float32 against the plain version in float64, 1e-5 of the
    largest value), and a constraint without entries gives exactly 0."""
    lp, sizes = _k7_layout(dtype, dev)
    g = torch.Generator(device=dev).manual_seed(41)
    u, v = (torch.randn(lp.n_cols, generator=g, dtype=dtype, device=dev)
            for _ in range(2))

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    planned = tup(K.lp_constr_segsum(lp, u, v, pair=pair))
    torch.cuda.synchronize()
    order = tup(K.lp_constr_segsum_order(lp, u, v, pair))
    lp64 = dataclasses.replace(lp, row_val=lp.row_val.double())
    want = tup(K.lp_constr_segsum_plain(lp64, u.double(), v.double(), pair))
    assert all(torch.equal(a, b) for a, b in zip(order, planned))
    again = tup(K.lp_constr_segsum(lp, u, v, pair=pair))
    assert all(torch.equal(a, b) for a, b in zip(again, planned))
    for a, b in zip(planned, want):
        if dtype == torch.float64:
            assert _rel(a, b) <= RTOL
        else:
            assert _maxrel(a, b) <= F32_TOL
        assert torch.count_nonzero(a[torch.tensor(sizes == 0)]) == 0


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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", LP_CASES)
def test_lp_col_wsum_has_the_plain_bits_with_every_block(dev, case, dtype):
    """K8 in every block size of ``K8_THREADS`` equals its plain version
    evaluated on the host bit for bit (the CSC order, no fused
    multiply-add), the ELL's padded slots and the tail columns included,
    also where w holds an infinity and a NaN (a padded slot reads
    constraint 0)."""
    m, n_cols, c, col, cid, vals = _lp_entries(case)
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, dev, dtype)
    host = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, "cpu", dtype)
    g = torch.Generator(device=dev).manual_seed(m)
    w = torch.randn(m, generator=g, dtype=torch.float64, device=dev).to(dtype)
    bad = w.clone()
    bad[0], bad[m // 2] = float("inf"), float("nan")
    for ww in (w, bad):
        want = K.lp_col_wsum_plain(host, ww.cpu(), 0.37)
        for threads in K.K8_THREADS:
            got = K.lp_col_wsum_with(threads, lp, ww, 0.37).cpu()
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            assert bool(same.all()), (threads, int((~same).sum()))


@cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", [1, 19, 20, 33, 64])
def test_spmm_sym_csr_every_plan_gives_the_planned_bits(dev, r, dtype):
    """K1 in every plan of ``k1_plans``, in its three modes (``alpha C Y``,
    ``C Y`` plus the row scale ``dv * w`` folded in, the row scale alone),
    bitwise equal to the planned launch; the folded row scale bitwise equal
    to ``d = dv * w`` formed first; the planned launch within the value
    type's unit roundoff of the plain version (2-norm relative)."""
    n = 1000
    rows, cols, vals = _upper(n, 3)
    csr = K.SymCSR.from_upper_coo(rows, cols, vals, n, dev, dtype)
    g = torch.Generator(device=dev).manual_seed(r)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev).to(dtype)

    Y, w = rnd(n, r), rnd(n)
    dv = rnd(n).abs() + 0.5
    tol = 2.2e-16 if dtype == torch.float64 else 1.2e-7
    modes = [(csr, Y, 0.37, None, None), (csr, Y, 1.0, dv, w),
             (None, Y, 0.0, dv, w)]
    want = [K.spmm_sym_csr(*m) for m in modes]
    assert torch.equal(want[1], K.spmm_sym_csr(csr, Y, 1.0, dv * w))
    assert torch.equal(want[2], K.spmm_sym_csr(None, Y, 0.0, dv * w))
    for m, planned in zip(modes, want):
        assert _rel(planned, K.spmm_sym_csr_plain(*m)) <= tol
    for plan in K.k1_plans(r, dtype):
        for m, planned in zip(modes, want):
            assert torch.equal(K.spmm_sym_csr_with(plan, *m), planned), plan


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


# --------------------------------------------------------------------------- #
# K9 gatv2_softmax_agg and K10 graph_pool (float32)
# --------------------------------------------------------------------------- #

F32_TOL = 1e-5    # max |kernel - plain| / max |plain|, float32


def _maxrel(a, b) -> float:
    return float((a.double() - b).abs().max()
                 / b.abs().max().clamp_min(1e-30))


def _f64(args):
    """The float tensors of ``args`` in float64, the rest as they are."""
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def _gat_inputs(case, dev):
    """(EdgeCSR, w_src, w_dst, we, we_loop, att) of a random graph: repeated
    edges, existing self-loops, a hub node with 100 incoming edges (several
    32-edge index loads), or no edge at all; heads x channels from the case
    name (every width the tuner samples, channel counts that are not powers
    of two, 3 heads, 4 x 64, rows past 256 channels: 3 x 96, 8 x 64, 4 x
    128 and one head of 256, odd and even channel counts for the scalar and float2 loads,
    and heads past 256 channels, the wide kernels: 1 x 300, 2 x 261)."""
    heads, ch = {"no-edges": (4, 16), "hub": (4, 16)}.get(case) or tuple(
        int(v) for v in case.split("x"))
    rng = np.random.default_rng(len(case))
    n, e = 300, 0 if case == "no-edges" else 2000
    ei = rng.integers(0, n, size=(2, e))
    if e:
        ei[1, :10] = ei[0, :10]              # existing self-loops
        ei[:, -5:] = ei[:, :5]               # repeated edges
    if case == "hub":
        ei[1, :100] = 7
    g = K.EdgeCSR.from_edge_index(torch.tensor(ei, device=dev), n)
    gen = torch.Generator(device=dev).manual_seed(e + n)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                   device=dev)

    hc = heads * ch
    return (g, rnd(n, hc), rnd(n, hc), rnd(e, hc), rnd(hc),
            rnd(heads, ch, scale=2.0))


GAT_CASES = ["4x16", "2x32", "8x8", "no-edges", "hub", "2x16", "4x12",
             "4x20", "2x48", "4x24", "3x32", "4x64", "3x96", "8x64", "1x256",
             "2x128", "4x128", "3x13", "5x6", "1x300", "2x261"]


@cuda
@pytest.mark.parametrize("case", GAT_CASES)
def test_gatv2_softmax_agg(dev, case):
    args = _gat_inputs(case, dev)
    before = K.KERNELS["gatv2_softmax_agg"].launches
    got = K.gatv2_softmax_agg(*args)
    torch.cuda.synchronize()
    want = K.gatv2_softmax_agg_plain(*_f64(args))
    assert _maxrel(got, want) <= F32_TOL
    assert torch.equal(K.gatv2_softmax_agg(*args), got)   # no atomics
    assert K.KERNELS["gatv2_softmax_agg"].launches == before + 2
    # every launch plan of the shape gives the same bits, in the serve and
    # in the training instance (out and lse)
    heads, ch = args[-1].shape

    def train_call(plan):
        sc = torch.empty((args[0].n_slots, heads), device=dev)
        return K.gatv2_softmax_agg_with(plan, *args, with_lse=True,
                                        scores=sc) + (sc,)

    train = train_call(None)
    assert torch.equal(train[0], got)
    # the scores handed to K11: the training instance's own
    want_s = K._gatv2_messages(*_f64(args))[2]
    assert _maxrel(train[2], want_s) <= F32_TOL
    for plan in K.k9_plans(heads, ch):
        again, _ = K.gatv2_softmax_agg_with(plan, *args)
        assert torch.equal(again, got), plan.describe()
        again = train_call(plan)
        assert all(torch.equal(a, b) for a, b in zip(again, train)), \
            plan.describe()


@cuda
@pytest.mark.parametrize("counts,d", [
    ((85080,), 64), ((5, 0, 300, 1), 64), ((700, 256, 257), 100),
    ((0,), 32), ((1000, 3), 128), ((700, 256, 257), 96),
    ((1000, 3), 200), ((85080,), 256), ((700, 256, 257), 384),
    ((5, 0, 300, 1), 600)])
def test_graph_pool(dev, counts, d):
    seg = K.GraphSegments.from_counts(counts, dev)
    gen = torch.Generator(device=dev).manual_seed(sum(counts) + d)
    n = sum(counts)
    x = torch.randn((n, d), generator=gen, dtype=torch.float32, device=dev)
    score = 5.0 * torch.randn(n, generator=gen, dtype=torch.float32,
                              device=dev)
    before = K.KERNELS["graph_pool"].launches
    got = K.graph_pool(seg, x, score)
    torch.cuda.synchronize()
    want = K.graph_pool_plain(seg, x.double(), score.double())
    assert got.shape == (len(counts), 3 * d)
    if n:
        for part in range(3):
            sl = slice(part * d, (part + 1) * d)
            assert _maxrel(got[:, sl], want[:, sl]) <= F32_TOL
    for b, c in enumerate(counts):
        if c == 0:                  # an empty graph pools to zeros
            assert torch.count_nonzero(got[b]) == 0
    assert torch.equal(K.graph_pool(seg, x, score), got)
    assert K.KERNELS["graph_pool"].launches == before + 2


K10_SIZES = (0, 1, 255, 256, 257, 85080)    # nodes of a graph


@cuda
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("d", [1, 64, 96, 256, 384])
def test_k10_every_plan_gives_the_same_bits(dev, d, train):
    """K10 on graphs of ``K10_SIZES`` nodes (chunk edges, an empty graph,
    the largest dataset graph) at widths of one lane, the serve
    checkpoint's, one not a power of two, one column block and two: every
    plan of ``k10_plans`` gives the planned launch's bits, and so does a
    second call; out matches the plain version evaluated in float64 (1e-5
    of the largest value of each part), stats to 1e-5 and the tie counts
    exactly (training: with a dropout keep-scale and features on a grid of
    1/2, so that nodes tie); K12 fed by this K10 matches its plain
    backward."""
    seg = K.GraphSegments.from_counts(K10_SIZES, dev)
    n = sum(K10_SIZES)
    gen = torch.Generator(device=dev).manual_seed(d + 7 * train)
    x = torch.randn((n, d), generator=gen, device=dev)
    if train:
        x = torch.round(2.0 * x) / 2.0
    score = 5.0 * torch.randn(n, generator=gen, device=dev)
    keep = _keep((n,), gen, dev) if train else None
    planned = K.graph_pool_with(None, seg, x, score, keep, train)
    torch.cuda.synchronize()
    for plan in K.k10_plans(d):
        got = K.graph_pool_with(plan, seg, x, score, keep, train)
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(got, planned)), plan.describe()
    again = K.graph_pool_with(None, seg, x, score, keep, train)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(again, planned))
    k64 = None if keep is None else keep.double()
    want = K._graph_pool_plain(seg, x.double(), score.double(), k64)
    out = planned[0]
    for part in range(3):
        sl = slice(part * d, (part + 1) * d)
        assert _maxrel(out[:, sl], want[0][:, sl]) <= F32_TOL, part
    assert torch.count_nonzero(out[0]) == 0          # the empty graph
    if not train:
        return
    out, stats, ties = planned
    assert _maxrel(stats, want[1]) <= F32_TOL
    assert torch.equal(ties.double(), want[2])
    assert float(ties.max()) > 1
    dout = torch.randn(out.shape, generator=gen, device=dev)
    got = K.graph_pool_bwd(seg, x, score, keep, out, stats, ties, dout)
    _check_outputs(got, K.graph_pool_bwd_plain(
        seg, x.double(), score.double(), k64, out.double(), stats.double(),
        ties.double(), dout.double()))


@cuda
def test_k10_captured_calls_keep_tickets_of_their_own(dev):
    """Two calls captured into one CUDA graph, replayed twice, give the
    eager call's bits: each captured call has its own tickets and
    partials."""
    seg = K.GraphSegments.from_counts((3000, 700), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((3700, 64), generator=gen, device=dev)
    score = torch.randn(3700, generator=gen, device=dev)
    want = K.graph_pool(seg, x, score)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        a = K.graph_pool(seg, x, score)
        b = K.graph_pool(seg, x, score)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, want) and torch.equal(b, want)


@cuda
def test_gnn_wrappers_reject_what_the_kernels_do_not_take(dev):
    g, w_src, w_dst, we, we_loop, att = _gat_inputs("4x16", dev)
    with pytest.raises(TypeError):
        K.gatv2_softmax_agg(g, w_src.double(), w_dst, we, we_loop, att)
    with pytest.raises(ValueError, match="shape"):
        K.gatv2_softmax_agg(g, w_src[:, :32].contiguous(),
                            w_dst[:, :32].contiguous(),
                            we[:, :32].contiguous(),
                            we_loop[:32].contiguous(), att)
    # K11 without K9's scores
    with pytest.raises(ValueError, match="scores"):
        K.gatv2_softmax_agg_bwd(g, w_src, w_dst, we, we_loop, att, None,
                                torch.zeros((g.n, 4), device=dev),
                                w_src, w_src)
    # a launch plan that is not one of the shape's (every width runs)
    with pytest.raises(ValueError, match="not a launch"):
        K.gatv2_softmax_agg_with(
            dataclasses.replace(K.k9_plan(4, 16), p=8), g, w_src, w_dst, we,
            we_loop, att)
    seg = K.GraphSegments.from_counts((10, 20), dev)
    x = torch.zeros((30, 260), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="d >= 1"):
        K.graph_pool(seg, x[:, 0].contiguous(), torch.zeros(30, device=dev))
    with pytest.raises(ValueError, match="nodes"):
        K.graph_pool(seg, x[:29, :64].contiguous(),
                     torch.zeros(29, device=dev))


# --------------------------------------------------------------------------- #
# K11 gatv2_softmax_agg_bwd and K12 graph_pool_bwd (float32), and the plain
# backwards they are held to
# --------------------------------------------------------------------------- #


def _keep(shape, gen, dev, p=0.15):
    u = torch.rand(shape, generator=gen, device=dev)
    return (u < 1 - p).float() / (1 - p)


@pytest.fixture
def one_thread():
    """gradcheck runs thousands of tiny ops: on one thread, so that test
    workers sharing the cores do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("heads,ch", [(4, 2), (2, 4)])
@pytest.mark.parametrize("dropout", [False, True])
def test_k9_plain_backward_gradcheck(one_thread, heads, ch, dropout):
    """The plain backward takes any heads x channels (the kernel 64, held
    on the card): eight channels keep the numerical Jacobian small."""
    rng = np.random.default_rng(heads * 10 + dropout)
    n, e = 10, 30
    ei = rng.integers(0, n, size=(2, e))
    ei[1, :2] = ei[0, :2]                   # existing self-loops
    ei[:, -1] = ei[:, 3]                    # a repeated edge
    g = K.EdgeCSR.from_edge_index(torch.tensor(ei), n)
    hc = heads * ch
    args = [torch.tensor(rng.standard_normal(shape), requires_grad=True)
            for shape in ((n, hc), (n, hc), (e, hc), (hc,), (heads, ch))]
    keep = (torch.tensor((rng.random((e + n, heads)) < 0.8) / 0.8)
            if dropout else None)
    K.reset_counts()
    assert torch.autograd.gradcheck(
        lambda *t: K.gatv2_softmax_agg(g, *t, keep=keep), args)
    assert K.counts()["gatv2_softmax_agg_bwd"][1] > 0


@pytest.mark.parametrize("dropout", [False, True])
def test_k10_plain_backward_gradcheck_with_ties(one_thread, dropout):
    """A graph whose column max is tied by two nodes: the central difference
    and the equal split both give each node half of the max's gradient."""
    rng = np.random.default_rng(3 + dropout)
    counts = (5, 0, 7, 3)
    seg = K.GraphSegments.from_counts(counts, "cpu")
    n, d = sum(counts), 6
    x = rng.standard_normal((n, d))
    x[1, 2] = x[3, 2] = 5.0                 # a tie at graph 0's max
    xt = torch.tensor(x, requires_grad=True)
    score = torch.tensor(rng.standard_normal(n), requires_grad=True)
    keep = (torch.tensor((rng.random(n) < 0.8) / 0.8) if dropout else None)
    _, _, ties = K._graph_pool_plain(seg, xt.detach(), score.detach())
    assert ties[0, 2] == 2
    K.reset_counts()
    assert torch.autograd.gradcheck(
        lambda a, b: K.graph_pool(seg, a, b, keep=keep), (xt, score))
    assert K.counts()["graph_pool_bwd"][1] > 0


def _check_outputs(got, want):
    """Each output within F32_TOL of its largest value, that scale floored
    at 1e-6 of the largest value of all outputs (an output whose exact value
    vanishes, such as d_w_dst where every slot's message has one sign, is
    rounding)."""
    floor = 1e-6 * max(float(b.abs().max()) for b in want if b.numel())
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if b.numel():
            scale = max(float(b.abs().max()), floor)
            assert float((a.double() - b).abs().max()) <= F32_TOL * scale


@cuda
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("case", GAT_CASES)
def test_gatv2_softmax_agg_bwd(dev, case, dropout):
    g, *args = _gat_inputs(case, dev)
    heads = args[-1].shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    keep = _keep((g.n_slots, heads), gen, dev) if dropout else None
    sc = torch.empty((g.n_slots, heads), device=dev)
    out, lse = K._gatv2_forward(g, *args, keep, True, scores=sc)
    want_out, want_lse = K._gatv2_plain(g, *_f64(args), None if keep is None
                                        else keep.double())
    assert _maxrel(out, want_out) <= F32_TOL
    assert _maxrel(lse, want_lse) <= F32_TOL
    dout = torch.randn(out.shape, generator=gen, device=dev)
    before = K.KERNELS["gatv2_softmax_agg_bwd"].launches
    got = K.gatv2_softmax_agg_bwd(g, *args, keep, lse, out, dout, sc)
    torch.cuda.synchronize()
    # the plain backward in float64 on the kernel's own inputs (K9's lse, out
    # and scores included); with no edge every slot is a self-loop, alpha = 1
    # and d_w_dst, d_we_loop and d_att vanish
    want = K.gatv2_softmax_agg_bwd_plain(
        g, *_f64(args), None if keep is None else keep.double(),
        lse.double(), out.double(), dout.double(), sc.double())
    _check_outputs(got, want)
    again = K.gatv2_softmax_agg_bwd(g, *args, keep, lse, out, dout, sc)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    # two calls, each one launch of K11 a head group (``k11_groups``)
    calls = len(K.k11_groups(heads, args[-1].shape[1]))
    assert K.KERNELS["gatv2_softmax_agg_bwd"].launches == before + 2 * calls


@pytest.mark.parametrize("case", ["4x16", "4x128", "1x256"])
def test_k11_plain_takes_the_forwards_scores(case):
    """The plain backward with the forward's own scores: in float32 the
    same bits as scores it evaluates itself (one function, one order); in
    float64 on float32 inputs with the float32 forward's scores, as K11 runs
    on K9's, within F32_TOL of the float64 chain in every output, the
    cancelling sums included."""
    cpu = torch.device("cpu")
    g, *args = _gat_inputs(case, cpu)
    o32, l32 = K._gatv2_plain(g, *args)
    s32 = K._gatv2_messages(g, *args)[2]
    dout = torch.randn(o32.shape, generator=torch.Generator().manual_seed(19))
    own = K.gatv2_softmax_agg_bwd_plain(g, *args, None, l32, o32, dout, s32)
    mine = K.gatv2_softmax_agg_bwd_plain(g, *args, None, l32, o32, dout)
    assert all(torch.equal(a, b) for a, b in zip(own, mine))
    a64 = _f64(args)
    o64, l64 = K._gatv2_plain(g, *a64)
    want = K.gatv2_softmax_agg_bwd_plain(g, *a64, None, l64, o64,
                                         dout.double())
    _check_outputs(K.gatv2_softmax_agg_bwd_plain(
        g, *a64, None, l32.double(), o32.double(), dout.double(),
        s32.double()), want)


@cuda
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("case", [c for c in GAT_CASES if c != "no-edges"])
def test_k9_then_k11_matches_the_float64_chain(dev, case, dropout):
    """K11 on K9's own lse, out and scores, as the autograd node runs them,
    against the float64 forward and backward of the same float32 inputs:
    d_w_dst, d_we_loop and d_att are sums that cancel, which hold only where
    K11's softmax weights are the ones K9 aggregated with.  Each output is
    held to F32_TOL of its largest value, or to twice the float32 plain
    chain's own error where that chain comes near F32_TOL itself (a head of
    256 channels).  Not on a graph without edges: there
    those three are 0 only in exact arithmetic (out = keep w_src rounds to
    float32), and the float32 plain chain itself misses them by 2 to 8 times
    their floor; ``test_gatv2_softmax_agg_bwd`` holds that case on K11's own
    inputs."""
    g, *args = _gat_inputs(case, dev)
    leaves = [a.clone().requires_grad_(True) for a in args]
    gen = torch.Generator(device=dev).manual_seed(23)
    heads = args[-1].shape[0]
    keep = _keep((g.n_slots, heads), gen, dev) if dropout else None
    out = K.gatv2_softmax_agg(g, *leaves, keep=keep)
    dout = torch.randn(out.shape, generator=gen, device=dev)
    out.backward(dout)
    a64, k64 = _f64(args), None if keep is None else keep.double()
    o64, l64 = K._gatv2_plain(g, *a64, k64)
    want = K.gatv2_softmax_agg_bwd_plain(g, *a64, k64, l64, o64,
                                         dout.double())
    o32, l32 = K._gatv2_plain(g, *args, keep)
    plain = K.gatv2_softmax_agg_bwd_plain(g, *args, keep, l32, o32, dout)
    floor = 1e-6 * max(float(b.abs().max()) for b in want)
    for a, p, b in zip((t.grad for t in leaves), plain, want):
        scale = max(float(b.abs().max()), floor)
        err_plain = float((p.double() - b).abs().max()) / scale
        err = float((a.double() - b).abs().max()) / scale
        assert err <= max(F32_TOL, 2.0 * err_plain), (err, err_plain)


@cuda
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("counts,d", [
    ((85080,), 64), ((5, 0, 300, 1), 64), ((700, 256, 257), 100),
    ((1000, 3), 128), ((700, 256, 257), 96), ((1000, 3), 200),
    ((5, 0, 300, 1), 256), ((700, 256, 257), 384)])
def test_graph_pool_bwd(dev, counts, d, dropout):
    seg = K.GraphSegments.from_counts(counts, dev)
    gen = torch.Generator(device=dev).manual_seed(sum(counts) + d)
    n = sum(counts)
    # values on a coarse grid: many nodes tie at each graph's column max
    x = torch.round(2.0 * torch.randn((n, d), generator=gen, device=dev))
    score = 5.0 * torch.randn(n, generator=gen, device=dev)
    keep = _keep((n,), gen, dev) if dropout else None
    out, stats, ties = K._graph_pool_forward(seg, x, score, keep, True)
    want = K._graph_pool_plain(seg, x.double(), score.double(),
                               None if keep is None else keep.double())
    _check_outputs((out, stats), want[:2])
    assert torch.equal(ties.double(), want[2])
    assert float(ties.max()) > 1
    dout = torch.randn(out.shape, generator=gen, device=dev)
    before = K.KERNELS["graph_pool_bwd"].launches
    got = K.graph_pool_bwd(seg, x, score, keep, out, stats, ties, dout)
    torch.cuda.synchronize()
    _check_outputs(got, K.graph_pool_bwd_plain(
        seg, x.double(), score.double(),
        None if keep is None else keep.double(), out.double(),
        stats.double(), ties.double(), dout.double()))
    again = K.graph_pool_bwd(seg, x, score, keep, out, stats, ties, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert K.KERNELS["graph_pool_bwd"].launches == before + 2


@cuda
def test_autograd_functions_launch_forward_and_backward_kernels(dev):
    g, *args = _gat_inputs("4x16", dev)
    leaves = [a.clone().requires_grad_(True) for a in args]
    K.reset_counts()
    out = K.gatv2_softmax_agg(g, *leaves)
    seg = K.GraphSegments.from_counts((100, 200), dev)
    pooled = K.graph_pool(seg, out, out[:, 0].contiguous())
    pooled.square().sum().backward()
    torch.cuda.synchronize()
    counts = K.counts()
    for name in ("gatv2_softmax_agg", "gatv2_softmax_agg_bwd", "graph_pool",
                 "graph_pool_bwd"):
        assert counts[name] == (1, 0), (name, counts[name])
    assert all(leaf.grad is not None for leaf in leaves)


# --------------------------------------------------------------------------- #
# K1-K8 on float32 values (the solver's --dtype float32)
# --------------------------------------------------------------------------- #

KERNEL_TOL = 1e-5     # float32 kernel / plain vs the float64 evaluation,
                      # relative to the output's largest magnitude


def _kernel_cases(dev, dtype):
    """``{name: (wrapper, plain, args)}`` for K1-K8 on one device in one
    value type, from numpy draws (the same numbers for either type)."""
    rng = np.random.default_rng(11)
    n, r = 600, 13

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    rows, cols, vals = _upper(n, 5)
    csr = K.SymCSR.from_upper_coo(rows, cols, vals, n, dev, dtype)
    Y, Z = t(rng.standard_normal((n, r))), t(rng.standard_normal((n, r)))
    d = t(rng.standard_normal(n))
    coef = t(np.where(rows != cols, 2.0 * vals, vals))
    ri = torch.tensor(rows, dtype=torch.int32, device=dev)
    ci = torch.tensor(cols, dtype=torch.int32, device=dev)
    m = 700
    arows = rng.integers(0, n, 3 * m)
    acols = np.maximum(arows, rng.integers(0, n, 3 * m))
    acid = np.concatenate([np.zeros(100, int), rng.integers(1, m, 3 * m - 100)])
    avals = rng.standard_normal(3 * m)
    seg = K.SegCOO.from_coo(arows, acols, avals, acid, n, m, dev, dtype)
    ccsr = K.ConstrCSR.from_upper_coo(arows, acols, avals, acid, n, m, dev,
                                      dtype)
    w = t(rng.standard_normal(m))
    n_lp = 900
    col = np.repeat(np.arange(n_lp), 3)
    lcid = rng.integers(0, m, col.size)
    lp = K.LPEntries.from_coo(rng.uniform(0.5, 1.5, n_lp), col, lcid,
                              rng.standard_normal(col.size), m, n_lp, dev,
                              dtype)
    u, v = t(rng.standard_normal(n_lp)), t(rng.standard_normal(n_lp))
    return {
        "spmm_sym_csr": (K.spmm_sym_csr, K.spmm_sym_csr_plain,
                         (csr, Y, 0.7, d)),
        "diag_rowdot": (K.diag_rowdot, K.diag_rowdot_plain,
                        (Y, Z, d, 2.0, True)),
        "diag_normal_matvec": (K.diag_normal_matvec,
                               K.diag_normal_matvec_plain, (Y, Z, d)),
        "sym_contract_sum": (K.sym_contract_sum, K.sym_contract_sum_plain,
                             (ri, ci, coef, Y, Z)),
        "coo_contract_segsum": (K.coo_contract_segsum,
                                K.coo_contract_segsum_plain,
                                (seg, Y, Z, True)),
        "spmm_constr_csr": (K.spmm_constr_csr, K.spmm_constr_csr_plain,
                            (ccsr, w, Y, Z, 1.0)),
        "lp_constr_segsum": (K.lp_constr_segsum, K.lp_constr_segsum_plain,
                             (lp, u, v, True)),
        "lp_col_wsum": (K.lp_col_wsum, K.lp_col_wsum_plain, (lp, w, 1.5)),
    }


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def _rel_to_scale(got, want) -> float:
    return max(float((g.double().cpu() - w.double().cpu()).abs().max())
               / max(float(w.abs().max()), 1e-300)
               for g, w in zip(_outs(got), _outs(want)))


K1_K8 = ["spmm_sym_csr", "diag_rowdot", "diag_normal_matvec",
         "sym_contract_sum", "coo_contract_segsum", "spmm_constr_csr",
         "lp_constr_segsum", "lp_col_wsum"]


def _f64(args):
    """``args`` with every float tensor, and every float tensor of a layout,
    in float64: the float64 evaluation of the same float32 inputs."""
    def up(v):
        return v.double() if torch.is_tensor(v) and v.is_floating_point() \
            else v

    out = []
    for a in args:
        if dataclasses.is_dataclass(a):
            a = type(a)(**{f.name: up(getattr(a, f.name))
                           for f in dataclasses.fields(a)})
        out.append(up(a))
    return tuple(out)


@cuda
@pytest.mark.parametrize("name", K1_K8)
def test_float32_kernels_on_the_card(dev, name):
    """Each of K1-K8 on float32 values against its plain version evaluated
    in float64 on the same inputs (K4, whose sums are float64, to 1e-10),
    the same bits on two calls."""
    wrapper, plain, args = _kernel_cases(dev, torch.float32)[name]
    before = K.KERNELS[name].launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    f64 = _f64(args)
    tol = 1e-10 if name == "sym_contract_sum" else KERNEL_TOL
    assert _rel_to_scale(got, plain(*f64)) <= tol
    again = wrapper(*args)
    assert all(torch.equal(a, b) for a, b in zip(_outs(got), _outs(again)))
    assert K.KERNELS[name].launches == before + 2


# --------------------------------------------------------------------------- #
# K13: the column sum of index-gathered rows
# --------------------------------------------------------------------------- #


@cuda
@pytest.mark.parametrize("n, m, r", [(8192, 262144, 32), (8192, 262144, 8),
                                     (4096, 100_003, 64), (1000, 77_777, 200),
                                     (1, 5000, 32), (300, 10, 17),
                                     (50, 0, 3), (2000, 300_001, 256)])
def test_gather_rowsum_matches_float64_plain(dev, n, m, r):
    Y, idx = probe_inputs(n, m, r, dev, seed=3)
    before = K.KERNELS["gather_rowsum"].launches
    got = K.gather_rowsum(Y, idx)
    again = K.gather_rowsum(Y, idx)
    torch.cuda.synchronize()
    assert K.KERNELS["gather_rowsum"].launches == before + 2
    assert tuple(got.shape) == (1, r) and torch.equal(got, again)
    want = K.gather_rowsum_plain(Y.double(), idx)
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * max(float(want.abs().max()), 1e-30)


@cuda
def test_gather_rowsum_refuses_what_it_does_not_take(dev):
    Y, idx = probe_inputs(64, 100, 8, dev)
    with pytest.raises(ValueError, match="columns"):
        K.gather_rowsum(torch.zeros((4, 257), device=dev), idx)
    with pytest.raises(TypeError):
        K.gather_rowsum(Y.double(), idx)
    with pytest.raises(TypeError):
        K.gather_rowsum(Y, idx.long())


# --------------------------------------------------------------------------- #
# K5 / K6: lane groups, tiles, strands and warps per row
# --------------------------------------------------------------------------- #

K56_RANKS = [1, 2, 3, 7, 8, 19, 32, 33, 64, 141, 256]


def _instantiated(name, macro):
    """The template arguments of every ``macro(...)`` case of a source's
    dispatch: the instantiations its C entry point launches."""
    import re

    src = (K.CSRC_DIR / f"{name}.cu").read_text()
    return {tuple(int(x) for x in m.split(","))
            for m in re.findall(macro + r"\((\d+, \d+(?:, \d+)?)\)", src)}


@pytest.mark.parametrize("r", K56_RANKS + [4, 5, 16, 17, 96, 129, 257, 600])
def test_lane_group_is_a_function_of_r(r):
    """G is the smallest power of two >= r, at most 32; a lane's CPL
    columns cover r in one pass up to 256 and in passes of 256 beyond."""
    g, cpl = K.lane_group(r)
    assert g & (g - 1) == 0 and g <= 32
    assert g >= min(r, 32) and (g == 1 or g // 2 < r)
    assert cpl == min(K.MAX_CPL, -(-r // g))
    passes = -(-r // (g * cpl))
    assert passes == (1 if r <= 32 * K.MAX_CPL else -(-r // 256))
    # K6 launches it; K5 too, but for 17 <= r <= 32 (16 lanes of 2)
    assert (K.k6_plan(r, 300, 67).g, K.k6_plan(r, 300, 67).cpl) == (g, cpl)
    p5 = K.k5_plan(r, 10**6)
    assert (p5.g, p5.cpl) == ((16, 2) if 17 <= r <= 32 else (g, cpl))


def _k5_cases():
    """K5's instantiations: the K5_CASE triples and each K5_CASE2 pair with
    kc 1 and 2."""
    k5 = _instantiated("coo_contract_segsum", "K5_CASE")
    return k5 | {(g, c, kc) for g, c in
                 _instantiated("coo_contract_segsum", "K5_CASE2")
                 for kc in (1, 2)}


@pytest.mark.parametrize("r", K56_RANKS)
@pytest.mark.parametrize("m", [1, 2_400, 216_171, 552_620])
def test_k5_plan_is_instantiated_and_fits_one_warp(r, m):
    """Every rank's K5 plan is a case of the source's dispatch; a warp's
    constraints fit one 32-lane load of their bounds; a group's row terms
    stay within eight; two constraints a group only where one a group
    leaves more than K5_FILL_TILES warps."""
    plan = K.k5_plan(r, m)
    assert (plan.g, plan.cpl, plan.kc) in _k5_cases()
    assert 1 <= plan.constraints_per_warp <= 32
    assert plan.kc in (1, 2) and plan.kc * plan.cpl <= K.MAX_CPL
    assert plan.g >= 32 or r <= plan.g * plan.cpl
    assert (plan.kc == 2) == (plan.g > 1 and 2 * plan.cpl <= K.MAX_CPL and
                              m * plan.g >= 32 * K.K5_FILL_TILES)
    assert plan.describe() == f"G={plan.g} CPL={plan.cpl} KC={plan.kc}"


def test_every_k5_and_k6_plan_is_instantiated():
    k5 = _k5_cases()
    k6 = _instantiated("spmm_constr_csr", "K6_CASE")
    assert len(k5) == 21 and len(k6) == 13
    for r in range(1, 600):
        for m in (10, 10**6):
            p5 = K.k5_plan(r, m)
            assert (p5.g, p5.cpl, p5.kc) in k5
        assert K.lane_group(r) in k6


@pytest.mark.parametrize("r", K56_RANKS)
def test_k5_tiles_cover_every_short_constraint_once(r):
    """The kernel's tiles as the host plans them: warp w serves constraints
    w * NC .. w * NC + NC - 1, group q its k-th at offset k * P + q; every
    constraint is walked by exactly one group, a long one by its chunks
    only."""
    n, m, rows, cols, vals, cid = _constraint_entries("long")
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, "cpu")
    plan = K.k5_plan(r, m)
    per, nc = 32 // plan.g, plan.constraints_per_warp
    lens = np.diff(seg.seg_ptr.numpy())
    walked = []
    for c0 in range(0, m, nc):
        for q in range(per):
            for k in range(plan.kc):
                c = c0 + k * per + q
                if c < m and lens[c] < seg.long_thresh:
                    walked.append(c)
    chunked = seg.long_seg.tolist()
    assert sorted(walked + chunked) == list(range(m))
    assert not set(walked) & set(chunked)


@pytest.mark.parametrize("n, max_row, want", [
    (10_000, 130, 1), (300, 67, 8), (1024, 1050, 4), (3000, 144, 1),
    (1000, 60, 2), (300, 0, 1), (5, 1, 1), (132 * 32, 10_000, 1)])
def test_k6_warps_per_row(n, max_row, want):
    """Warps per row: as many as the longest row's chunks can use while n
    rows alone leave the card short of warps; never more than the strands,
    and the same for every r with the same lane group."""
    r = 141 if (n, max_row) == (300, 67) else 8
    plan = K.k6_plan(r, n, max_row)
    assert plan.wpr == want
    assert plan.wpr in (1, 2, 4, 8) and plan.wpr <= K.K6_STRANDS
    chunks = -(-max_row // (min(plan.g, K.K6_STEPS) * 32 // plan.g))
    assert plan.wpr == 1 or plan.wpr < 2 * chunks
    assert plan.describe().endswith(f"W={plan.wpr}")


def test_k6_plan_grows_with_long_rows_and_few_rows():
    for r in K56_RANKS:
        for n in (10, 300, 3000, 100_000):
            w = [K.k6_plan(r, n, L).wpr for L in (0, 8, 64, 512, 10**5)]
            assert w == sorted(w)
        for L in (16, 1000):
            w = [K.k6_plan(r, n, L).wpr for n in (100_000, 3000, 300, 10)]
            assert w == sorted(w)


def _lengths_entries(seed=0):
    """(n, m, rows, cols, vals, cid): constraints of 0 (id 1), 1, 2, 5, 31,
    32, 33 and 1,000 entries and 400 of one entry, so that K6's rows have 0,
    1, a few, 31, 32, 33 and 1,000 slots."""
    rng = np.random.default_rng(seed)
    n = 1100
    segs = [  # (row, col) lists, constraint ids 0, 2, 3, ...
        [(0, j) for j in range(1, 1001)],                  # row 0: 1,000
        [(1001, j) for j in range(1, 32)],                 # row 1001: 31
        [(1002, j) for j in range(1, 33)],                 # row 1002: 32
        [(1003, j) for j in range(1, 34)],                 # row 1003: 33
        [(i, i) for i in range(1004, 1009)],               # 5 diagonal
        [(1009, 1010), (1009, 1009)],
        [(1011, 1012)]]
    rows, cols, cid = [], [], []
    for k, s in enumerate(segs):
        rows += [a for a, _ in s]
        cols += [b for _, b in s]
        cid += [k if k == 0 else k + 1] * len(s)
    one_r = rng.integers(1013, 1040, 400)
    one_c = rng.integers(1013, 1040, 400)
    rows += list(np.minimum(one_r, one_c))
    cols += list(np.maximum(one_r, one_c))
    cid += list(range(len(segs) + 1, len(segs) + 401))
    rows, cols, cid = (np.asarray(x, np.int64) for x in (rows, cols, cid))
    return n, int(cid.max()) + 1, rows, cols, rng.standard_normal(rows.size), \
        cid


def _mss_entries(n=300, deg=8, seed=7):
    """A maximum stable set cone as HALLaR lays it out for K6: an entry per
    edge and C = -ee^T as constraint m, so every row holds about n slots."""
    from ltr_lowrank_sdp_torch.hallar.solver import build_mss_problem

    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(n * deg // 2, 2))
    e = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
    p = build_mss_problem([tuple(x) for x in e.tolist()], n)
    return (n, p.m + 1,
            np.concatenate([p.a_rows, p.c_rows]).astype(np.int64),
            np.concatenate([p.a_cols, p.c_cols]).astype(np.int64),
            np.concatenate([p.a_vals, p.c_vals]),
            np.concatenate([p.a_cid, np.full(p.c_rows.size, p.m)]))


def _k56_entries(case):
    if case == "lengths":
        return _lengths_entries()
    if case == "mss":
        return _mss_entries()
    return _constraint_entries(case)


def test_lengths_and_mss_cases_have_the_shapes_they_name():
    n, m, rows, cols, vals, cid = _lengths_entries()
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, "cpu")
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, "cpu")
    lens = np.diff(seg.seg_ptr.numpy())
    assert {0, 1, 2, 5, 31, 32, 33, 1000} <= set(lens.tolist())
    slots = np.diff(csr.indptr.numpy())
    assert {0, 1, 31, 32, 33} <= set(slots.tolist())
    assert csr.max_row == slots.max() == 1000
    assert seg.long_seg.tolist() == list(np.flatnonzero(lens >= 32))
    n, m, rows, cols, vals, cid = _mss_entries()
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, "cpu")
    assert np.diff(csr.indptr.numpy()).min() >= n


@pytest.mark.parametrize("case", ["lengths", "mss", "theta", "matcomp"])
def test_shard_layouts_are_the_whole_layouts_restricted(case):
    """What a rank of the sharded operators builds (meshops): K6's row
    slice keeps each kept row's slots in the full layout's order, and K5's
    constraint segment holds the full layout's segments, long-segment
    chunks included, shifted to its own start: each output's terms, and so
    its bits, are the full layout's."""
    n, m, rows, cols, vals, cid = _k56_entries(case)
    whole = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, "cpu")
    wseg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, "cpu")
    wptr = whole.indptr.numpy()
    sptr = wseg.seg_ptr.numpy()
    for lo, hi in ((0, n // 3), (n // 3, n)):
        part = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, "cpu",
                                          row_range=(lo, hi))
        pptr = part.indptr.numpy()
        a, b = wptr[lo], wptr[hi]
        assert np.array_equal(pptr[lo:hi + 1] - pptr[lo], wptr[lo:hi + 1] - a)
        assert np.all(np.diff(pptr)[:lo] == 0) and np.all(
            np.diff(pptr)[hi:] == 0)
        for f in ("indices", "vals", "cid"):
            assert torch.equal(getattr(part, f), getattr(whole, f)[a:b])
        assert part.max_row == np.diff(wptr)[lo:hi].max(initial=0)
    for lo, hi in ((0, m // 2), (m // 2, m)):
        own = (cid >= lo) & (cid < hi)
        seg = K.SegCOO.from_coo(rows[own], cols[own], vals[own],
                                cid[own] - lo, n, hi - lo, "cpu")
        a = sptr[lo]
        assert np.array_equal(seg.seg_ptr.numpy(), sptr[lo:hi + 1] - a)
        for f in ("rows", "cols", "coef"):
            assert torch.equal(getattr(seg, f),
                               getattr(wseg, f)[a:sptr[hi]])
        mine = [i for i in range(wseg.long_seg.numel() if wseg.n_chunks
                                 else 0)
                if lo <= int(wseg.long_seg[i]) < hi]
        got = seg.chunk_ptr.numpy().tolist() if seg.n_chunks else []
        want = [[s - a, e - a] for i in mine for s, e in
                wseg.chunk_ptr.numpy()[int(wseg.long_ptr[i]):
                                       int(wseg.long_ptr[i + 1])].tolist()]
        assert got == want


def _k56_inputs(case, r, dev, dtype=torch.float64, seed=0):
    n, m, rows, cols, vals, cid = _k56_entries(case)
    seg = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev, dtype)
    csr = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, dev, dtype)
    rng = np.random.default_rng(seed + r)
    U, V, Z = (torch.tensor(rng.standard_normal((n, r)), dtype=dtype,
                            device=dev) for _ in range(3))
    w = torch.tensor(rng.standard_normal(m), dtype=dtype, device=dev)
    return seg, csr, U, V, Z, w


@cuda
@pytest.mark.parametrize("r", K56_RANKS)
@pytest.mark.parametrize("case", ["lengths", "mss", "theta"])
def test_k5_redesign_matches_plain(dev, case, r):
    """K5's lane groups and tiles at every rank of its instantiations, on
    segments of 0 to 1,000 entries: all three modes against the plain
    version (1e-12), an empty constraint exactly 0, the same bits twice and
    with one or two constraints a group."""
    seg, _, U, V, _, _ = _k56_inputs(case, r, dev)
    plan = K.k5_plan(r, seg.m)
    for a, b, pair in ((U, V, False), (U, U, False), (U, V, True)):
        got = K.coo_contract_segsum(seg, a, b, pair=pair)
        for kc in (1, 2) if plan.g > 1 and 2 * plan.cpl <= K.MAX_CPL else ():
            other = K.coo_contract_segsum_with(
                K.K5Plan(plan.g, plan.cpl, kc), seg, a, b, pair=pair)
            assert all(torch.equal(x, y) for x, y in zip(
                other if pair else (other,), got if pair else (got,)))
        again = K.coo_contract_segsum(seg, a, b, pair=pair)
        want = K.coo_contract_segsum_plain(seg, a, b, pair=pair)
        torch.cuda.synchronize()
        for x, y, z in zip(*(t if pair else (t,) for t in (got, want,
                                                          again))):
            assert _rel(x, y) <= RTOL
            assert torch.equal(x, z)
            if case == "lengths":
                assert float(x[1]) == 0.0


@cuda
@pytest.mark.parametrize("r", K56_RANKS)
@pytest.mark.parametrize("case", ["lengths", "mss", "theta"])
def test_k6_redesign_matches_plain_at_every_warps_per_row(dev, case, r):
    """K6 at every rank of its instantiations on rows of 0 to 1,000 slots:
    alone, with the addend at beta = -0.5 and with zero weights, against
    the plain version (1e-12); every warps-per-row value gives the bits of
    the planned launch."""
    _, csr, U, _, Z, w = _k56_inputs(case, r, dev)
    w0 = torch.where(torch.arange(w.numel(), device=dev) % 3 == 0, 0.0, w)
    g, cpl = K.lane_group(r)
    for args in ((csr, w, U), (csr, w, U, Z, -0.5), (csr, w0, U, Z, -0.5)):
        got = K.spmm_constr_csr(*args)
        torch.cuda.synchronize()
        assert _rel(got, K.spmm_constr_csr_plain(*args)) <= RTOL
        for wpr in (1, 2, 4, 8):
            assert torch.equal(
                K.spmm_constr_csr_with(K.K6Plan(g, cpl, wpr), *args), got)


@cuda
@pytest.mark.parametrize("r", [3, 19, 141])
@pytest.mark.parametrize("case", ["lengths", "mss", "theta"])
def test_k5_k6_redesign_float32(dev, case, r):
    """float32 K5 (pair) and K6 (with the addend) against the plain version
    evaluated in float64 on the same inputs: within 1e-5 of the output's
    largest magnitude; the same bits twice."""
    seg, csr, U, V, Z, w = _k56_inputs(case, r, dev, torch.float32)
    seg64, csr64, U64, V64, Z64, w64 = _f64((seg, csr, U, V, Z, w))
    got = K.coo_contract_segsum(seg, U, V, pair=True)
    assert _rel_to_scale(got, K.coo_contract_segsum_plain(
        seg64, U64, V64, pair=True)) <= KERNEL_TOL
    assert all(torch.equal(a, b) for a, b in zip(
        got, K.coo_contract_segsum(seg, U, V, pair=True)))
    got = K.spmm_constr_csr(csr, w, U, Z, -0.5)
    assert _rel_to_scale(got, K.spmm_constr_csr_plain(
        csr64, w64, U64, Z64, -0.5)) <= KERNEL_TOL
    assert torch.equal(got, K.spmm_constr_csr(csr, w, U, Z, -0.5))


@cuda
@pytest.mark.parametrize("r", [2, 7, 19, 141])
@pytest.mark.parametrize("case", ["lengths", "theta", "matcomp"])
def test_k5_k6_shards_give_the_whole_layouts_bits(dev, case, r):
    """On the card: a rank's K6 row slice gives the full layout's rows and
    its K5 constraint segment the full layout's constraint values, bit for
    bit (meshops adds exact zeros elsewhere)."""
    n, m, rows, cols, vals, cid = _k56_entries(case)
    seg, csr, U, V, _, w = _k56_inputs(case, r, dev)
    whole6 = K.spmm_constr_csr(csr, w, U)
    whole5 = K.coo_contract_segsum(seg, U, V, pair=True)
    for lo, hi in ((0, n // 3), (n // 3, n)):
        part = K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m, dev,
                                          row_range=(lo, hi))
        got = K.spmm_constr_csr(part, w, U)
        assert torch.equal(got[lo:hi], whole6[lo:hi])
        assert not got[:lo].any() and not got[hi:].any()
    for lo, hi in ((0, m // 2), (m // 2, m)):
        own = (cid >= lo) & (cid < hi)
        part = K.SegCOO.from_coo(rows[own], cols[own], vals[own],
                                 cid[own] - lo, n, hi - lo, dev)
        got = K.coo_contract_segsum(part, U, V, pair=True)
        assert all(torch.equal(g, x[lo:hi]) for g, x in zip(got, whole5))


def test_ptxas_usage_reads_each_instantiation(monkeypatch):
    """The registers and spills of each template instantiation, keyed by its
    value type and int arguments, from ``-Xptxas -v`` output."""
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122spmm_"
        "constr_csr_kernelIdLi32ELi5EEEvPKiS2_PKT_S2_S5_S5_S5_PS3_iiS3_i' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_122spmm_"
        "constr_csr_kernelIdLi32ELi5EEEvPKiS2_PKT_S2_S5_S5_S5_PS3_iiS3_i",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers, 10240 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122coo_long_"
        "reduce_kernelIfEEvPKiS2_iiPKT_S5_PS3_S6_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 12 registers, used 0 barriers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126coo_contract"
        "_segsum_kernelILi2EfLi16ELi2ELi2EEEvPKiS2_S2_PKT0_S5_S5_iiiPS3_S6_iiS2_"
        "iS6_S6_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 70 registers, used 0 barriers, 400 bytes cmem[0]"])
    monkeypatch.setattr(K.KERNELS["spmm_constr_csr"], "build_log", log)
    assert K.ptxas_usage("spmm_constr_csr") == {
        ("main", "f64", (32, 5)): (96, 8, 4),
        ("long_reduce", "f32", ()): (12, 0, 0),
        ("main", "f32", (2, 16, 2, 2)): (70, 0, 0)}
