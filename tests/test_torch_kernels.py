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
    of two, 3 heads, and the widest row K9 takes, 4 x 64)."""
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
             "4x20", "2x48", "4x24", "3x32", "4x64"]


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


@cuda
@pytest.mark.parametrize("counts,d", [
    ((85080,), 64), ((5, 0, 300, 1), 64), ((700, 256, 257), 100),
    ((0,), 32), ((1000, 3), 128), ((700, 256, 257), 96),
    ((1000, 3), 200), ((85080,), 256)])
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
    # wider than K9 takes: 4 x 72 = 288, and 3 heads x 72 channels (three
    # heads take 8 lanes each, so at most 64 channels)
    for heads, ch in ((4, 72), (3, 72)):
        wide = torch.zeros((g.n, heads * ch), device=dev)
        with pytest.raises(ValueError, match="heads \\* channels <= 256"):
            K.gatv2_softmax_agg(
                g, wide, wide, torch.zeros((g.n_real, heads * ch),
                                           device=dev),
                torch.zeros(heads * ch, device=dev),
                torch.zeros((heads, ch), device=dev))
    seg = K.GraphSegments.from_counts((10, 20), dev)
    x = torch.zeros((30, 260), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="d <= 256"):
        K.graph_pool(seg, x, torch.zeros(30, device=dev))
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
    out, lse = K._gatv2_forward(g, *args, keep, True)
    want_out, want_lse = K._gatv2_plain(g, *_f64(args), None if keep is None
                                        else keep.double())
    assert _maxrel(out, want_out) <= F32_TOL
    assert _maxrel(lse, want_lse) <= F32_TOL
    dout = torch.randn(out.shape, generator=gen, device=dev)
    before = K.KERNELS["gatv2_softmax_agg_bwd"].launches
    got = K.gatv2_softmax_agg_bwd(g, *args, keep, lse, out, dout)
    torch.cuda.synchronize()
    # the plain backward in float64 on the kernel's own inputs (K9's lse and
    # out included); with no edge every slot is a self-loop, alpha = 1 and
    # d_w_dst, d_we_loop and d_att vanish
    want = K.gatv2_softmax_agg_bwd_plain(
        g, *_f64(args), None if keep is None else keep.double(),
        lse.double(), out.double(), dout.double())
    _check_outputs(got, want)
    again = K.gatv2_softmax_agg_bwd(g, *args, keep, lse, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics
    assert K.KERNELS["gatv2_softmax_agg_bwd"].launches == before + 2


@cuda
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("counts,d", [
    ((85080,), 64), ((5, 0, 300, 1), 64), ((700, 256, 257), 100),
    ((1000, 3), 128), ((700, 256, 257), 96), ((1000, 3), 200),
    ((5, 0, 300, 1), 256)])
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
