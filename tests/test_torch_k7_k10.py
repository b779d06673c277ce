"""The host side of K7 (``lp_constr_segsum``) and K10 (``graph_pool``) on
the CPU: the layout ``LPEntries`` stores, K7's sum order in plain PyTorch (``lp_constr_segsum_order``) against a numpy walk of
the same slots and tree, K10's plans, chunks and scratch widths, and the
two-level softmax that K10 combines its chunks with, each against a numpy
rebuild; the constants that the CUDA sources and ``ops/kernels.py`` share.
The kernels themselves are held on the card by the ``-m cuda`` tests in
``test_torch_kernels.py``.
"""

import re

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K


def _source(name):
    return (K.CSRC_DIR / f"{name}.cu").read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))


# --------------------------------------------------------------------------- #
# K7
# --------------------------------------------------------------------------- #


def test_k7_round_matches_the_source():
    assert _const(_source("lp_constr_segsum"), "kRound") == K.K7_ROUND


def _lp_case(seed, m=40, n_cols=300):
    rng = np.random.default_rng(seed)
    sizes = rng.choice([0, 1, 7, 31, 32, 33, 90], m)
    cid = np.repeat(np.arange(m), sizes)
    order = rng.permutation(cid.size)
    cid = cid[order]
    col = rng.integers(0, n_cols, cid.size)
    vals = rng.standard_normal(cid.size)
    return m, n_cols, rng.uniform(0.5, 1.5, n_cols), col, cid, vals, sizes


def test_lp_entries_layout_matches_a_numpy_rebuild():
    m, n_cols, c, col, cid, vals, sizes = _lp_case(0)
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, "cpu")
    by_cid = sorted(range(cid.size), key=lambda e: (cid[e], e))
    by_col = sorted(range(cid.size), key=lambda e: (col[e], e))
    np.testing.assert_array_equal(
        lp.row_ptr.numpy(), np.concatenate([[0], np.cumsum(sizes)]))
    np.testing.assert_array_equal(lp.row_col.numpy(), col[by_cid])
    np.testing.assert_array_equal(lp.row_val.numpy(), vals[by_cid])
    np.testing.assert_array_equal(
        lp.col_ptr.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(col, minlength=n_cols))]))
    np.testing.assert_array_equal(lp.col_cid.numpy(), cid[by_col])
    np.testing.assert_array_equal(lp.col_val.numpy(), vals[by_col])
    assert lp.row_ptr.dtype == lp.row_col.dtype == torch.int32


def _slot_walk(lp, u, v, pair):
    """K7's order by hand, one numpy scalar operation at a time."""
    ptr, col = lp.row_ptr.numpy(), lp.row_col.numpy()
    val = lp.row_val.numpy()
    outs = ([], []) if pair else ([],)
    for i in range(lp.m):
        slots = [np.zeros(K.K7_ROUND, val.dtype) for _ in outs]
        for j, e in enumerate(range(ptr[i], ptr[i + 1])):
            terms = (val[e] * (u[col[e]] * v[col[e]]),
                     val[e] * (v[col[e]] * v[col[e]]))
            for s, t in zip(slots, terms):
                s[j % K.K7_ROUND] = s[j % K.K7_ROUND] + t
        for out, s in zip(outs, slots):
            while s.size > 1:
                s = s[:s.size // 2] + s[s.size // 2:]
            out.append(s[0])
    res = [np.array(o, val.dtype) for o in outs]
    if pair:
        res[0] = val.dtype.type(2) * res[0]
    return res


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k7_order_is_the_slot_tree(dtype, pair):
    """``lp_constr_segsum_order`` gives the bits of the slot walk (entry j
    into slot j mod 32, round by round, then the halving tree), and matches
    the dense product to 1e-12 (float64) or 1e-5 of the largest value
    (float32); a constraint without entries gives exactly 0."""
    m, n_cols, c, col, cid, vals, sizes = _lp_case(1)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    lp = K.LPEntries.from_coo(c, col, cid, vals, m, n_cols, "cpu", tdt)
    rng = np.random.default_rng(2)
    u = rng.standard_normal(n_cols).astype(dtype)
    v = rng.standard_normal(n_cols).astype(dtype)
    got = K.lp_constr_segsum_order(lp, torch.tensor(u), torch.tensor(v),
                                   pair)
    got = [t.numpy() for t in (got if pair else (got,))]
    for a, b in zip(got, _slot_walk(lp, u, v, pair)):
        np.testing.assert_array_equal(a, b)
    A = np.zeros((m, n_cols))
    np.add.at(A, (cid, col), vals.astype(dtype).astype(np.float64))
    u64, v64 = u.astype(np.float64), v.astype(np.float64)
    want = ([2.0 * (A @ (u64 * v64)), A @ (v64 * v64)] if pair
            else [A @ (u64 * v64)])
    for a, b in zip(got, want):
        if dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        else:
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        assert not a[sizes == 0].any()


# --------------------------------------------------------------------------- #
# K10
# --------------------------------------------------------------------------- #


def test_k10_constants_match_the_sources():
    fwd, bwd = _source("graph_pool"), _source("graph_pool_bwd")
    assert _const(fwd, "kChunk") == K.K10_CHUNK
    assert _const(bwd, "kChunkNodes") == K.K10_CHUNK
    assert _const(fwd, "kMaxD") == _const(bwd, "kMaxD") == K.K10_MAX_D
    assert _const(fwd, "kBuf") == K.K10_BUF
    cases = {tuple(int(v) for v in c) for c in
             re.findall(r"K10_CASE\((\d+), (\d+)\)", fwd)}
    want = {(K.k10_lanes(d), K.k10_cpl(d)) for d in range(1, 257)}
    assert cases == want


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 17, 32, 63, 64, 65, 96,
                               128, 129, 200, 256, 300, 384, 600])
def test_k10_plans_against_numpy(d):
    cols = min(d, K.K10_MAX_D)
    lanes = int(min(32, 2 ** np.ceil(np.log2(max(1, np.ceil(cols / 4))))))
    cpl = 8 if cols > 4 * lanes else 4
    assert (K.k10_lanes(d), K.k10_cpl(d)) == (lanes, cpl)
    assert lanes * cpl >= cols                 # every column has a lane
    assert cpl == 4 or lanes == 32
    plans = K.k10_plans(d)
    plan = plans[0]
    assert plan == K.k10_plan(d)
    assert plan.vec == (4 if d % 4 == 0 else 1)
    assert plan.depth == K.K10_BUF // cpl
    assert len(set(plans)) == len(plans)
    assert {p.depth for p in plans} == {k for k in K.K10_DEPTHS
                                        if k * cpl <= K.K10_BUF}
    assert {p.vec for p in plans} == {plan.vec, 1}
    assert all((p.lanes, p.cpl) == (lanes, cpl) for p in plans)
    assert K.k10_plan(d, aligned=False).vec == 1
    dp = int(np.ceil(d / 4) * 4)
    assert K.k10_part_width(d) == 4 * -(-d // K.K10_MAX_D) + 4 * dp
    assert K.k10_part_width(d) % 4 == 0


@pytest.mark.parametrize("counts", [(0,), (1, 0, 255, 256, 257), (85080,),
                                    (0, 0, 3), (600, 0)])
def test_graph_segments_against_numpy(counts):
    seg = K.GraphSegments.from_counts(counts, "cpu")
    starts, ends, graphs = [], [], []
    for b, c in enumerate(counts):
        first = sum(counts[:b])
        for s in range(first, first + c, K.K10_CHUNK):
            starts.append(s)
            ends.append(min(s + K.K10_CHUNK, first + c))
            graphs.append(b)
    np.testing.assert_array_equal(seg.chunk_start.numpy(), starts)
    np.testing.assert_array_equal(seg.chunk_end.numpy(), ends)
    np.testing.assert_array_equal(seg.chunk_graph.numpy(), graphs)
    per = [-(-c // K.K10_CHUNK) for c in counts]
    np.testing.assert_array_equal(seg.chunk_ptr.numpy(),
                                  np.concatenate([[0], np.cumsum(per)]))
    np.testing.assert_array_equal(seg.empty.numpy(),
                                  [b for b, c in enumerate(counts) if c == 0])
    assert seg.n_empty + sum(1 for c in counts if c) == len(counts)


@pytest.mark.parametrize("keep", [False, True])
def test_k10_chunk_maxima_combine_to_the_plain_softmax(keep):
    """K10's two levels in numpy (float64): per chunk of ``K10_CHUNK``
    nodes its score max m_c, l_c = sum exp(s - m_c) and the keep-weighted
    sums; per graph M = max m_c, l = sum l_c exp(m_c - M) and the weighted
    sums rescaled the same way: the plain version's stats and attention
    output, a graph of -inf scores included."""
    counts = (700, 1, 0, 513)
    seg = K.GraphSegments.from_counts(counts, "cpu")
    rng = np.random.default_rng(4)
    n, d = sum(counts), 6
    x = rng.standard_normal((n, d))
    s = 8.0 * rng.standard_normal(n)
    s[700] = -np.inf
    kp = (rng.random(n) < 0.85) / 0.85 if keep else np.ones(n)
    st, en = seg.chunk_start.numpy(), seg.chunk_end.numpy()
    part = []
    for a, b in zip(st, en):
        m = s[a:b].max()
        mu = m if np.isfinite(m) else 0.0
        p = np.exp(s[a:b] - mu)
        part.append((m, p.sum(), (p * kp[a:b]) @ x[a:b]))
    out, stats = np.zeros((len(counts), d)), np.zeros((len(counts), 2))
    cp = seg.chunk_ptr.numpy()
    for g in range(len(counts)):
        ps = part[cp[g]:cp[g + 1]]
        if not ps:
            continue
        M = max(m for m, _, _ in ps)
        MU = M if np.isfinite(M) else 0.0
        f = [np.exp((m if np.isfinite(m) else 0.0) - MU) for m, _, _ in ps]
        lsum = sum(fi * l for fi, (_, l, _) in zip(f, ps))
        out[g] = sum(fi * w for fi, (_, _, w) in zip(f, ps)) / (lsum + 1e-16)
        stats[g] = (MU, lsum)
    got, gstats, _ = K._graph_pool_plain(
        seg, torch.tensor(x), torch.tensor(s),
        torch.tensor(kp) if keep else None)
    np.testing.assert_allclose(got[:, 2 * d:].numpy(), out, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gstats.numpy(), stats, rtol=1e-12,
                               atol=1e-12)
