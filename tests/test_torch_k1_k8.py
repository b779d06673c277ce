"""The host side of K1 (``spmm_sym_csr``) and K8 (``lp_col_wsum``) on the
CPU: K1's plans against the instantiations of its source, K8's slot-major
ELL (column order, counts, tail list, padding) against a numpy rebuild, and
the plain versions against the JAX package's ``EllSpMM.apply`` and
``LPOps.weighted_col_sums`` on the same inputs (float64, 1e-13 relative).
The kernels themselves are held on the card by the ``-m cuda`` tests in
``test_torch_kernels.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.testing import multiblock_lp_problem
from ltr_lowrank_sdp_tpu.ops import coneops as jax_coneops
from ltr_lowrank_sdp_tpu.ops.gatherseg import EllSpMM

RTOL = 1e-13
DTYPES = [torch.float64, torch.float32]


def _source(name):
    return (K.CSRC_DIR / f"{name}.cu").read_text()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# --------------------------------------------------------------------------- #
# K1
# --------------------------------------------------------------------------- #


def _k1_instances():
    """{(value bytes, v, g, nv, s)} instantiated by ``spmm_sym_csr.cu``:
    each ``K1_STEPS(v, nv)`` for both value types (those after the
    ``sizeof(T) == 4`` test for float32 only), the three steps that fit
    ``kMaxInFlight`` and the six groups."""
    src = _source("spmm_sym_csr")
    cap = int(re.search(r"constexpr int kMaxInFlight = (\d+);", src).group(1))
    assert cap == K.K1_MAX_IN_FLIGHT
    body = src[src.index("int dispatch("):src.index("#undef K1_STEPS")]
    f32_only = body.index("sizeof(T) == 4")
    out = set()
    for m in re.finditer(r"K1_STEPS\((\d+), (\d+)\)", body):
        v, nv = int(m.group(1)), int(m.group(2))
        for size in (4,) if m.start() > f32_only else (4, 8):
            for g in (1, 2, 4, 8, 16, 32):
                out.update((size, v, g, nv, st) for st in K.K1_STEPS
                           if st * nv * v <= cap)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_plan_is_valid_and_instantiated_for_every_rank(dtype):
    """r = 1 .. 300: the default plan and every plan of ``k1_plans`` cover
    r, are instantiated, load at most 16 bytes, and the default takes the
    widest vector that divides r, then the fewest vectors a lane that leave
    at most 8 lanes a row, then the most entries a step whose gathers fit
    ``K1_STEP_BYTES`` (at least 2); ``k1_plans`` lists no plan twice and
    holds the default."""
    size = 4 if dtype == torch.float32 else 8
    inst = _k1_instances()
    for r in range(1, 301):
        plan = K.k1_plan(r, dtype)
        plans = K.k1_plans(r, dtype)
        assert plan in plans and len(set(plans)) == len(plans)
        for p in plans:
            assert p.covers(r) and (size, p.v, p.g, p.nv, p.s) in inst, (
                r, p)
            assert p.v * size <= 16 and p.g in (1, 2, 4, 8, 16, 32)
            if p.g > 1:     # the smallest group that covers r in one pass
                assert p.g * p.nv * p.v < 2 * r or p.g == 32
        widest = max(v for v in (1, 2, 4) if v * size <= 16 and r % v == 0)
        assert plan.v == widest
        want = next((nv for nv in K.K1_NV
                     if K._k1_group(r, widest, nv) <= 8), K.K1_NV[-1])
        assert plan.nv == want
        fits = [st for st in K.K1_STEPS
                if st * want * widest * size <= K.K1_STEP_BYTES]
        assert plan.s == max(fits or [2])
        assert plan.s * plan.nv * plan.v <= K.K1_MAX_IN_FLIGHT


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_plan_follows_the_address_alignment(dtype):
    size = 4 if dtype == torch.float32 else 8
    for align, r in ((size, 64), (2 * size, 64), (16, 64), (16, 20)):
        plan = K.k1_plan(r, dtype, align)
        assert align % (plan.v * size) == 0 and plan.covers(r)
    assert K.k1_plan(64, dtype, size).v == 1


def _sym_case(n, seed, r):
    rng = np.random.default_rng(seed)
    nnz = 4 * n
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    key = np.unique(lo * n + hi)
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size)
    return rows, cols, vals, rng.standard_normal((n, r)), rng


@pytest.mark.parametrize("r", [1, 7, 20])
def test_k1_plain_matches_jax_ellspmm_apply(r):
    """``spmm_sym_csr_plain`` = JAX's ``EllSpMM.apply`` (scaled), and with
    the row scale = that plus ``(dv * w)[:, None] * Y`` (JAX's
    ``ConeOps.apply_a`` under ``diag_identity``), float64."""
    n = 97
    rows, cols, vals, Y, rng = _sym_case(n, r, r)
    dv, w = rng.uniform(0.5, 1.5, n), rng.standard_normal(n)
    ell = EllSpMM(rows, cols, n, vals)
    csr = K.SymCSR.from_upper_coo(rows, cols, vals, n, "cpu")
    Yt, dvt, wt = torch.tensor(Y), torch.tensor(dv), torch.tensor(w)
    for alpha in (1.0, 0.37):
        want = np.asarray(ell.apply(jnp.asarray(Y), alpha))
        assert _rel(K.spmm_sym_csr_plain(csr, Yt, alpha), want) <= RTOL
        want_d = want + (dv * w)[:, None] * Y
        assert _rel(K.spmm_sym_csr_plain(csr, Yt, alpha, dvt, wt),
                    want_d) <= RTOL
    assert _rel(K.spmm_sym_csr_plain(None, Yt, 0.0, dvt, wt),
                (dv * w)[:, None] * Y) <= RTOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_folded_row_scale_is_the_product_on_the_cpu(dtype):
    """The wrapper's ``w`` forms ``d * w`` as the plain version of the
    caller's own product did: the same bits, one plain call, no launch and
    no fold counted."""
    n, r = 64, 5
    rows, cols, vals, Y, rng = _sym_case(n, 1, r)
    csr = K.SymCSR.from_upper_coo(rows, cols, vals, n, "cpu", dtype)
    Yt = torch.tensor(Y, dtype=dtype)
    dv = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=dtype)
    w = torch.tensor(rng.standard_normal(n), dtype=dtype)
    K.reset_counts()
    for c, alpha in ((csr, 1.0), (csr, 0.5), (None, 0.0)):
        got = K.spmm_sym_csr(c, Yt, alpha, d=dv, w=w)
        assert torch.equal(got, K.spmm_sym_csr_plain(c, Yt, alpha, dv * w))
    k = K.KERNELS["spmm_sym_csr"]
    assert (k.launches, k.plain_calls, k.folds) == (0, 3, 0)
    with pytest.raises(ValueError):
        K.spmm_sym_csr(csr, Yt, 1.0, w=w)


# --------------------------------------------------------------------------- #
# K8
# --------------------------------------------------------------------------- #


def test_k8_widths_match_the_source():
    widths = [int(v) for v in re.findall(r"K8_CASE\((\d+)\)",
                                         _source("lp_col_wsum"))]
    assert widths == list(range(1, K.K8_MAX_W + 1))


def test_k8_width_and_block_rules():
    assert K.k8_width(np.array([], np.int64)) == 1
    assert K.k8_width(np.zeros(5, np.int64)) == 1
    assert K.k8_width(np.array([1, 3, 3, 2])) == 3
    assert K.k8_width(np.array([8] * 10)) == 8
    assert K.k8_width(np.array([3] * 1000 + [40])) == 3
    assert K.k8_width(np.array([1] * 50 + [20] * 50)) == K.K8_MAX_W
    assert K.k8_plan(20000) == 512 and K.k8_plan(200000) == 512
    assert K.k8_plan(100) == 128 and K.k8_plan(1) == 32
    for n_cols in (1, 31, 33, 300, 511, 4000, 10**6):
        t = K.k8_plan(n_cols)
        assert t in K.K8_THREADS and (t >= n_cols or t == 512)
        assert t == 32 or t // 2 < n_cols


def _generated_cone():
    lp = multiblock_lp_problem().lp
    return lp.m, lp.n_cols, lp.c, lp.col, lp.cid, lp.vals


def _ragged_cone():
    """Empty columns, one-entry columns and long ones (past K8_MAX_W), the
    entries of a column scattered through the problem's order."""
    rng = np.random.default_rng(5)
    m, n_cols = 30, 400
    counts = rng.choice([0, 1, 2, 3, 3, 3, 5], n_cols)
    counts[[7, 123, 399]] = (40, 9, 70)
    col = np.repeat(np.arange(n_cols), counts)
    col = col[rng.permutation(col.size)]
    return (m, n_cols, rng.uniform(0.5, 1.5, n_cols), col,
            rng.integers(0, m, col.size), rng.standard_normal(col.size))


CONES = {"generated": _generated_cone, "ragged": _ragged_cone}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cone", sorted(CONES))
def test_k8_ell_holds_each_column_in_csc_order(cone, dtype):
    """Slot k of column j holds the column's k-th entry in the problem's
    order (the CSC's), the count its number of entries, a column longer
    than the width is -1 there, on the tail list (ascending) and has no
    slot filled, and every padded slot is (0, 0)."""
    m, n_cols, c, col, cid, vals = CONES[cone]()
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, "cpu", dtype)
    counts = np.bincount(col, minlength=n_cols)
    W = lp.ell_width
    assert W == K.k8_width(counts)
    assert lp.ell_val.dtype == dtype and lp.ell_cid.dtype == torch.int32
    ecid = lp.ell_cid.numpy().reshape(W, n_cols)
    evals = lp.ell_val.double().numpy().reshape(W, n_cols)
    cnt = lp.ell_cnt.numpy()
    tail = [j for j in range(n_cols) if counts[j] > W]
    np.testing.assert_array_equal(lp.tail_col.numpy(), tail)
    if cone == "ragged":
        assert tail and (counts == 0).any()
    vals_t = torch.tensor(vals, dtype=dtype).double().numpy()
    for j in range(n_cols):
        mine = np.flatnonzero(col == j)          # the problem's order
        if counts[j] > W:
            assert cnt[j] == -1
            assert not ecid[:, j].any() and not evals[:, j].any()
            continue
        assert cnt[j] == counts[j]
        np.testing.assert_array_equal(ecid[:counts[j], j], cid[mine])
        np.testing.assert_array_equal(evals[:counts[j], j], vals_t[mine])
        assert not ecid[counts[j]:, j].any()
        assert not evals[counts[j]:, j].any()


def test_k8_plain_matches_jax_weighted_col_sums():
    """``lp_col_wsum_plain`` = JAX's ``LPOps.weighted_col_sums`` on the
    generated cone and on the ragged one, float64."""
    for make in CONES.values():
        m, n_cols, c, col, cid, vals = make()
        lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, "cpu")
        jlp = jax_coneops.LPOps(jax_coneops.LPConeData(
            n_cols=n_cols, m=m, c=np.asarray(c, np.float64),
            col=np.asarray(col, np.int32), cid=np.asarray(cid, np.int32),
            vals=np.asarray(vals, np.float64),
            nrm2sq=np.zeros(m)), jnp.float64)
        w = np.random.default_rng(2).standard_normal(m)
        for c0 in (1.0, 0.37, 0.0):
            want = np.asarray(jlp.weighted_col_sums(jnp.asarray(w), c0))
            got = K.lp_col_wsum_plain(lp, torch.tensor(w), c0)
            assert _rel(got, want) <= RTOL
