"""K2 (``diag_rowdot``) and K12 (``graph_pool_bwd``) as redesigned for the
card.

On the CPU: K2's sum order, evaluated on the host by
``kernels.diag_rowdot_order`` as each lane-group plan takes it, bitwise
against a plain emulation of the order it keeps (a warp a row, 32 lanes,
a shuffle-down tree), for r = 1 .. 70 in both value types; the exact fused
multiply-add that both evaluate with; K2's plans against the source's
instantiations; K12's plans, tickets and scratch on the host and the
constants its source shares with K10's.

On the card (``-m cuda``, ``python -m pytest --noconftest
tests/test_torch_k2_k12.py -m cuda``): every K2 plan and grid gives
``diag_rowdot_order``'s bits at r = 1, 5, 19, 20, 33, 64 and 141 in both
types, with and without the second output; every K12 plan gives the
planned launch's bits, ``dx`` the float64 plain version's within float32
rounding, and one call is one device kernel.
"""

import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.testing import captured_kernel_nodes

cuda = pytest.mark.cuda

K2_RANKS = [1, 5, 19, 20, 33, 64, 141]
DTYPES = [torch.float64, torch.float32]
NP = {torch.float64: np.float64, torch.float32: np.float32}


def _source(name):
    return (K.CSRC_DIR / f"{name}.cu").read_text()


# --------------------------------------------------------------------------- #
# K2 on the host
# --------------------------------------------------------------------------- #


def test_exact_fma_rounds_once():
    """``_fma_exact`` against exact rational arithmetic: float64's result
    is Python's correctly rounded conversion of the exact value, float32's
    the nearest float32 (no neighbour closer), with ties to even."""
    rng = np.random.default_rng(0)
    for _ in range(3000):
        a, b, c = rng.normal(size=3) * 10.0 ** rng.integers(-6, 6, 3)
        assert K._fma_exact(a, b, c, 53) == float(
            Fraction(a) * Fraction(b) + Fraction(c))
        a, b, c = (float(v) for v in np.float32([a, b, c]))
        got = np.float32(K._fma_exact(a, b, c, 24))
        exact = Fraction(a) * Fraction(b) + Fraction(c)
        err = abs(Fraction(float(got)) - exact)
        for nb in (np.nextafter(got, np.float32(-np.inf)),
                   np.nextafter(got, np.float32(np.inf))):
            other = abs(Fraction(float(nb)) - exact)
            assert err < other or (err == other and
                                   int(got.view(np.int32)) % 2 == 0)
    # a tie (1 + 2^-24 is halfway between two float32s) goes to even
    assert K._fma_exact(1.0, 1.0, 2.0 ** -24, 24) == 1.0
    assert K._fma_exact(1.0 + 2.0 ** -23, 1.0, 2.0 ** -24, 24) == (
        1.0 + 2.0 ** -22)
    assert str(K._fma_exact(-0.0, 1.0, -0.0, 53)) == "-0.0"
    assert str(K._fma_exact(-1.0, 1.0, 1.0, 53)) == "0.0"


def _old_order(U, V, dv, s, second):
    """The order of K2 before its redesign, as its kernel evaluated it: a
    warp a row, lane l adding columns l, l + 32, ... by fused
    multiply-adds, then ``x += __shfl_down_sync(x, o)`` for o = 16, 8, 4,
    2, 1 over all 32 lanes (a lane past the warp's end reads its own)."""
    uv, vv = K.k2_chains(U, V)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        src = np.where(lanes + o < 32, lanes + o, lanes)
        uv, vv = uv + uv[:, src], vv + vv[:, src]
    o1 = (U.dtype.type(s) * dv) * uv[:, 0]
    return (o1, dv * vv[:, 0]) if second else (o1,)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ranks", [range(1, 24), range(24, 48),
                                   range(48, 71)])
def test_k2_order_of_every_plan_is_the_old_order(dtype, ranks):
    """For r in ``ranks``: ``diag_rowdot_order`` under every plan of
    ``k2_plans`` (lane groups of G lanes, J virtual lanes a lane, the slots
    past J skipped) gives the bits of the old 32-lane order, both outputs;
    rows with a zero column, a zero row and huge and tiny magnitudes
    included."""
    rng = np.random.default_rng(len(ranks) + ranks[0])
    for r in ranks:
        U = rng.normal(size=(6, r)) * 10.0 ** rng.integers(-3, 4, (6, r))
        V = rng.normal(size=(6, r))
        U[1] = 0.0
        V[2, ::3] = 0.0
        U, V = U.astype(NP[dtype]), V.astype(NP[dtype])
        dv = rng.uniform(0.5, 2.0, 6).astype(NP[dtype])
        want = _old_order(U, V, dv, 2.0, True)
        for plan in K.k2_plans(r, dtype):
            got = K.diag_rowdot_order(U, V, dv, 2.0, True, plan)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy().view(np.uint8),
                                      b.view(np.uint8)), (r, plan)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_order_is_the_plain_version_within_rounding(dtype):
    rng = np.random.default_rng(7)
    U = rng.normal(size=(50, 20)).astype(NP[dtype])
    V = rng.normal(size=(50, 20)).astype(NP[dtype])
    dv = rng.uniform(0.5, 2.0, 50).astype(NP[dtype])
    got = K.diag_rowdot_order(U, V, dv, 2.0, True)
    want = K.diag_rowdot_plain(*(torch.from_numpy(a).double()
                                 for a in (U, V, dv)), 2.0, True)
    eps = float(np.finfo(NP[dtype]).eps)
    for a, b in zip(got, want):
        assert float((a.double() - b).abs().max() / b.abs().max()) <= 8 * eps


def _k2_instances():
    body = _source("diag_rowdot")
    body = body[body.index("int dispatch("):body.index("#undef K2_CASE")]
    return {(int(g), int(j)) for g, j in
            re.findall(r"K2_CASE\((\d+), (\d+)\)", body)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_plans_are_valid_and_instantiated(dtype):
    """r = 0 .. 300: every plan of ``k2_plans`` holds min(r, 32) virtual
    lanes (J G), J a power of two of at most ``K2_MAX_SLOTS``, and is
    instantiated in the source; the planned one comes first, no plan
    twice, and it takes the fewest lanes that leave a lane at most
    ``K2_PLAN_SLOTS`` virtual lanes (4 for one pass of 32 columns, 2 for
    more)."""
    inst = _k2_instances()
    for r in range(0, 301):
        plans = K.k2_plans(r, dtype)
        assert plans[0] == K.k2_plan(r, dtype)
        assert len(set(plans)) == len(plans)
        for p in plans:
            assert (p.lanes, p.slots) in inst, (r, p)
            assert p.lanes * p.slots >= min(max(r, 1), 32)
            assert p.slots <= K.K2_MAX_SLOTS and p.slots & (p.slots - 1) == 0
        g, cap = plans[0].lanes, K.K2_PLAN_SLOTS[0 if r <= 32 else 1]
        assert plans[0].slots <= cap
        assert g == 1 or K._k2_slots(r, g // 2) > cap
    assert K.k2_plan(20, dtype) == K.K2Plan(8, 4)
    assert K.k2_plan(64, dtype) == K.K2Plan(16, 2)
    assert K.k2_plan(1, dtype) == K.K2Plan(1, 1)


def test_k2_on_the_cpu_is_the_plain_version():
    U, V = torch.randn(9, 5, dtype=torch.float64), torch.randn(
        9, 5, dtype=torch.float64)
    dv = torch.rand(9, dtype=torch.float64)
    before = K.KERNELS["diag_rowdot"].plain_calls
    for got, want in zip(K.diag_rowdot(U, V, dv, 2.0, True),
                         K.diag_rowdot_plain(U, V, dv, 2.0, True)):
        assert torch.equal(got, want)
    assert K.KERNELS["diag_rowdot"].plain_calls == before + 1


# --------------------------------------------------------------------------- #
# K12 on the host
# --------------------------------------------------------------------------- #


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))


def test_k12_constants_match_k10():
    src = _source("graph_pool_bwd")
    assert _const(src, "kChunkNodes") == K.K10_CHUNK
    assert _const(src, "kMaxD") == K.K10_MAX_D
    assert _const(src, "kBuf") == K.K10_BUF


def test_k12_instantiates_every_k10_plan():
    """K12 walks its nodes in K10's layout: every (lanes, channels a lane)
    of ``k10_plans`` at d = 1 .. 1200 is a ``K12_CASE`` of the source."""
    body = _source("graph_pool_bwd")
    inst = {(int(a), int(b)) for a, b in
            re.findall(r"K12_CASE\((\d+), (\d+)\)", body)}
    for d in range(1, 1201):
        for plan in K.k10_plans(d) + K.k10_plans(d, aligned=False):
            assert (plan.lanes, plan.cpl) in inst, (d, plan)


@pytest.mark.parametrize("counts,d", [((85080,), 64), ((5, 0, 300, 1), 96),
                                      ((700, 256, 257), 384),
                                      ((1, 2, 3), 257)])
def test_k12_tickets_and_partials_follow_the_chunk_layout(counts, d):
    """A graph's chunks are contiguous and in node order (the order in
    which the last chunk adds their partials), one ticket a graph, and one
    a chunk where d > 256 (the chunk's last column block adds the blocks'
    dots in column-block order)."""
    seg = K.GraphSegments.from_counts(counts, "cpu")
    ptr, cptr = seg.ptr.numpy(), seg.chunk_ptr.numpy()
    start, end = seg.chunk_start.numpy(), seg.chunk_end.numpy()
    for b, n in enumerate(counts):
        cs = range(cptr[b], cptr[b + 1])
        assert len(cs) == -(-n // K.K10_CHUNK)
        if n:
            assert start[cs[0]] == ptr[b] and end[cs[-1]] == ptr[b + 1]
            assert all(end[c] == start[c + 1] for c in cs[:-1])
            assert all(0 < end[c] - start[c] <= K.K10_CHUNK for c in cs)
        assert all(seg.chunk_graph[c] == b for c in cs)
    wide = d > K.K10_MAX_D
    assert K.k12_tickets(len(counts), seg.n_chunks, d) == len(counts) + (
        seg.n_chunks if wide else 0)


def test_k12_on_the_cpu_is_the_plain_version():
    seg = K.GraphSegments.from_counts((7, 0, 300), "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn((307, 12), generator=g)
    score = torch.randn(307, generator=g)
    out, stats, ties = K._graph_pool_plain(seg, x, score)
    dout = torch.randn(out.shape, generator=g)
    got = K.graph_pool_bwd(seg, x, score, None, out, stats, ties, dout)
    want = K.graph_pool_bwd_plain(seg, x, score, None, out, stats, ties, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    K.build_kernels()
    return torch.device("cuda", torch.cuda.current_device())


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", K2_RANKS)
def test_k2_every_plan_gives_the_order_bits(dev, dtype, r):
    """Every plan of ``k2_plans`` and a one-block grid, both modes: the
    bits of ``diag_rowdot_order`` (on the first 300 rows)."""
    gen = torch.Generator(device=dev).manual_seed(r)
    n = 3000
    U = torch.randn((n, r), generator=gen, device=dev,
                    dtype=torch.float64).to(dtype)
    V = torch.randn((n, r), generator=gen, device=dev,
                    dtype=torch.float64).to(dtype)
    dv = torch.rand(n, generator=gen, device=dev, dtype=torch.float64).to(
        dtype)
    want = K.diag_rowdot_order(U[:300].cpu(), V[:300].cpu(), dv[:300].cpu(),
                               2.0, True)
    planned = K.diag_rowdot(U, V, dv, 2.0, second=True)
    assert all(torch.equal(a[:300].cpu(), b) for a, b in zip(planned, want))
    for plan in K.k2_plans(r, dtype):
        for grid in (None, 1):
            got = K.diag_rowdot_with(plan, U, V, dv, 2.0, True, grid)
            assert all(torch.equal(a, b) for a, b in zip(got, planned)), (
                plan, grid)
            one = K.diag_rowdot_with(plan, U, V, dv, 1.0, False, grid)
            assert torch.equal(one, K.diag_rowdot(U, V, dv, 1.0))


@cuda
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("counts,d", [
    ((85080,), 64), ((5, 0, 300, 1), 64), ((700, 256, 257), 100),
    ((700, 256, 257), 96), ((1000, 3), 200), ((5, 0, 300, 1), 256),
    ((700, 256, 257), 384), ((300, 1), 257)])
def test_k12_every_plan_gives_the_same_bits_in_one_kernel(dev, counts, d,
                                                           dropout):
    seg = K.GraphSegments.from_counts(counts, dev)
    gen = torch.Generator(device=dev).manual_seed(sum(counts) + d)
    n = sum(counts)
    x = torch.round(2.0 * torch.randn((n, d), generator=gen, device=dev))
    score = torch.round(2.0 * torch.randn(n, generator=gen, device=dev))
    keep = None
    if dropout:
        keep = (torch.rand(n, generator=gen, device=dev) > 0.15).float() / 0.85
    out, stats, ties = K._graph_pool_forward(seg, x, score, keep, True)
    dout = torch.randn(out.shape, generator=gen, device=dev)
    args = (seg, x, score, keep, out, stats, ties, dout)
    want = K.graph_pool_bwd(*args)
    ref = K.graph_pool_bwd_plain(seg, x.double(), score.double(),
                                 None if keep is None else keep.double(),
                                 out.double(), stats.double(), ties.double(),
                                 dout.double())
    for a, b in zip(want, ref):
        scale = max(float(b.abs().max()), 1e-6 * float(ref[0].abs().max()))
        assert float((a.double() - b).abs().max()) / scale <= 1e-5
    for plan in K.k10_plans(d):
        got = K.graph_pool_bwd_with(plan, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), plan
    assert captured_kernel_nodes(lambda: K.graph_pool_bwd(*args)) == 1
