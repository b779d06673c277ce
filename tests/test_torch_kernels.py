"""The four CUDA kernels of the port against their plain PyTorch versions,
on the GPU.  Marked ``cuda``: they build the kernels with nvcc and skip on
a machine without a GPU.  Run them there with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the port's GPU
machine need not have; this file imports none of it.)

Tolerance: 1e-12 relative in the 2-norm (float64; the kernels sum in
another order than the plain versions).
"""

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.testing import delaunay_maxcut_adjacency

pytestmark = pytest.mark.cuda

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


@pytest.mark.parametrize("n,r", [(1000, 20), (777, 64), (129, 33)])
def test_diag_normal_matvec(dev, n, r):
    g = torch.Generator(device=dev).manual_seed(n)
    x, F = (torch.randn((n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    dv = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    assert _rel(K.diag_normal_matvec(x, F, dv),
                K.diag_normal_matvec_plain(x, F, dv)) <= RTOL


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
