"""The six CUDA kernels of the port against their plain PyTorch versions,
on the GPU.  Those tests are marked ``cuda``: they build the kernels with
nvcc and skip on a machine without a GPU.  Run them there with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the port's GPU
machine need not have; this file imports none of it.)

The plain versions of K5 and K6 and the two host-built layouts they share
with the kernels are held against a dense numpy evaluation on the CPU
(unmarked tests; K1-K4's are in ``test_torch_isolation.py``).

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
    else:
        raise AssertionError(case)
    keep = cid != 1
    rows, cols, cid = rows[keep], cols[keep], cid[keep]
    return n, m, rows, cols, rng.standard_normal(rows.size), cid


CASES = ["several", "matcomp", "diag", "trace"]


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
