"""K3 (``diag_normal_matvec``) and K13 (``gather_rowsum``) as redesigned for
the card, on the host.

K3: ``kernels.diag_normal_matvec_order`` (the lane-group kernel's result
evaluated on the host with exact fused multiply-adds) under every plan
against an emulation of the one-warp-a-row kernel it replaced (its 32-lane
shuffle-down tree, then ``fma(coef, F, x)``), at r = 1 .. 64 and 141 in both
value types; against the plain version within the unit roundoff; K3's plans
against the source's instantiations.

K13: ``kernels.gather_rowsum_order`` (the counts plan's bits) against the
probe's Pallas ``kern`` in interpret mode and its XLA baseline ``f_xla``,
within 1e-5 of the largest sum (the three add the same float32 terms in
other orders), and against a scalar emulation of the kernel's loops bit for
bit; the plan choice and the grid.

The kernels themselves are held on the card by the ``-m cuda`` cases of
``test_torch_k2_k12.py`` (K3) and ``test_torch_kernels.py`` (K13).
"""

import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ltr_lowrank_sdp_torch.ops import kernels as K

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROBE = ROOT / "scripts" / "pallas_gather_probe.py"
DTYPES = [torch.float64, torch.float32]
NP = {torch.float64: np.float64, torch.float32: np.float32}
TOL = 1e-5


def _bits_equal(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


# --------------------------------------------------------------------------- #
# K3
# --------------------------------------------------------------------------- #


def _k3_old_order(x, F, dv):
    """The arithmetic of the one-warp-a-row kernel that K3 replaced: a warp
    a row, lane l adding columns l, l + 32, ... by fused multiply-adds (nvcc
    contracted ``dot += x * F``),
    ``dot += __shfl_down_sync(dot, o)`` for o = 16 .. 1 over all 32 lanes (a
    lane past the warp's end reads its own), lane 0's dot to every lane,
    ``coef = d * (d * dot)``, then ``y = fma(coef, F, x)`` (nvcc contracted
    ``x + coef * F``)."""
    dot = K.k2_chains(x, F)[0]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        dot = dot + dot[:, np.where(lanes + o < 32, lanes + o, lanes)]
    coef = dv * (dv * dot[:, 0])
    mant = 24 if x.dtype == np.float32 else 53
    y = np.empty_like(x)
    for i, j in np.ndindex(*x.shape):
        y[i, j] = K._fma_exact(float(coef[i]), float(F[i, j]), float(x[i, j]),
                               mant)
    return y


def _k3_inputs(r, dtype, seed, n=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, r)) * 10.0 ** rng.integers(-3, 4, (n, r))
    F = rng.normal(size=(n, r))
    x[1] = 0.0
    F[2, ::3] = 0.0
    dv = rng.uniform(0.5, 2.0, n)
    return x.astype(NP[dtype]), F.astype(NP[dtype]), dv.astype(NP[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ranks", [range(1, 23), range(23, 45), range(45, 65),
                                   [141]])
def test_k3_order_of_every_plan_is_the_old_order(dtype, ranks):
    """For r in ``ranks``: ``diag_normal_matvec_order`` under every plan of
    ``k2_plans`` (K3 takes K2's lane groups) gives the bits of the
    one-warp-a-row kernel's arithmetic; rows with a zero x, zeros in F and
    huge and tiny magnitudes included."""
    for r in ranks:
        x, F, dv = _k3_inputs(r, dtype, seed=r)
        want = _k3_old_order(x, F, dv)
        for plan in K.k2_plans(r, dtype):
            got = K.diag_normal_matvec_order(x, F, dv, plan)
            assert _bits_equal(got.numpy(), want), (r, plan)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_order_is_the_plain_version_within_rounding(dtype):
    x, F, dv = _k3_inputs(20, dtype, seed=7, n=50)
    got = K.diag_normal_matvec_order(x, F, dv)
    want = K.diag_normal_matvec_plain(*(torch.from_numpy(a).double()
                                        for a in (x, F, dv)))
    eps = float(np.finfo(NP[dtype]).eps)
    assert got.dtype == dtype
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 8 * eps


def _k3_instances():
    body = (K.CSRC_DIR / "diag_normal_matvec.cu").read_text()
    body = body[body.index("int dispatch("):body.index("#undef K3_CASE")]
    return {(int(g), int(j)) for g, j in
            re.findall(r"K3_CASE\((\d+), (\d+)\)", body)}


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_plans_are_valid_and_instantiated(dtype):
    """r = 0 .. 300: every plan of ``k2_plans``, which K3 launches, holds
    min(r, 32) virtual lanes (J G) and is a ``K3_CASE`` of K3's source, whose
    list is K2's; the planned one comes first (its choice is held in
    ``test_torch_k2_k12.py``)."""
    inst = _k3_instances()
    k2_body = (K.CSRC_DIR / "diag_rowdot.cu").read_text()
    assert inst == {(int(g), int(j)) for g, j in
                    re.findall(r"K2_CASE\((\d+), (\d+)\)", k2_body)}
    for r in range(0, 301):
        plans = K.k2_plans(r, dtype)
        assert plans[0] == K.k2_plan(r, dtype)
        for p in plans:
            assert (p.lanes, p.slots) in inst, (r, p)
            assert p.lanes * p.slots >= min(max(r, 1), 32)


def test_k3_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(1)
    x, F = (torch.randn(9, 5, generator=g, dtype=torch.float64)
            for _ in range(2))
    dv = torch.rand(9, generator=g, dtype=torch.float64)
    k = K.KERNELS["diag_normal_matvec"]
    before = (k.plain_calls, k.launches)
    assert torch.equal(K.diag_normal_matvec(x, F, dv),
                       K.diag_normal_matvec_plain(x, F, dv))
    assert (k.plain_calls, k.launches) == (before[0] + 1, before[1])


# --------------------------------------------------------------------------- #
# K13
# --------------------------------------------------------------------------- #

TILE = 1024           # the Pallas kern's index tile at these sizes


def _probe_kern():
    """``kern`` of the probe script, compiled from its own source (the
    script runs its measurement when imported)."""
    tree = ast.parse(PROBE.read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "kern")
    ns = {"jnp": jnp, "pl": pl}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE), "exec"),
         ns)
    return ns["kern"]


def _pallas(Y, idx):
    n, r = Y.shape
    f = pl.pallas_call(
        _probe_kern(), grid=(idx.size // TILE,),
        in_specs=[
            pl.BlockSpec((TILE,), lambda g: (g,), memory_space=pltpu.VMEM),
            pl.BlockSpec((n, r), lambda g: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, r), lambda g: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, r), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, r), jnp.float32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(idx), jnp.asarray(Y)))


def _f_xla(Y, idx):
    f = jax.jit(lambda y, i: y[i].sum(axis=0))     # the probe's f_xla
    return np.asarray(f(jnp.asarray(Y), jnp.asarray(idx)))[None]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * max(np.max(np.abs(want)),
                                                   1e-30)


# (N, M, R, indices): the probe test's small size, M < N, all equal
@pytest.mark.parametrize("n,m,r,kind", [(256, 4096, 8, "uniform"),
                                        (4096, 2048, 32, "uniform"),
                                        (300, 3072, 17, "equal")])
def test_k13_order_matches_the_pallas_kern_and_f_xla(n, m, r, kind):
    rng = np.random.default_rng(n + m)
    Y = rng.standard_normal((n, r)).astype(np.float32)
    idx = (np.full(m, n // 2) if kind == "equal"
           else rng.integers(0, n, size=m)).astype(np.int32)
    got = K.gather_rowsum_order(Y, idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, r)
    _close(got.numpy(), _pallas(Y, idx))
    _close(got.numpy(), _f_xla(Y, idx))
    _close(got.numpy(), Y.astype(np.float64)[idx].sum(0, keepdims=True))


def test_k13_order_of_no_index_is_zero():
    Y = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    idx = np.zeros(0, np.int32)
    got = K.gather_rowsum_order(Y, idx).numpy()
    assert _bits_equal(got, np.zeros((1, 3), np.float32))
    assert _bits_equal(got, _f_xla(Y, idx).astype(np.float32))


def _k13_loops(Y, idx):
    """The counts plan's kernel, loop by loop in float32 scalars: counts,
    then for each chunk each strand's rows in order, the strands by the
    warps' xor shuffles and the block's tree over 8 warps, the chunks in
    order."""
    N, R = Y.shape
    L = min(32, 1 << (R - 1).bit_length())
    S, W = 256 // L, 32 // L
    rows = 8 * S
    c = np.zeros(N, np.int64)
    for i in idx:
        if 0 <= i < N:
            c[i] += 1
    out = np.zeros(R, np.float32)
    for r0 in range(0, N, rows):
        strand = np.zeros((S, R), np.float32)
        for s in range(S):
            for i in range(8):
                k = r0 + s + i * S
                if k < N and c[k]:
                    strand[s] = strand[s] + np.float32(c[k]) * Y[k]
        for h in (1, 2, 4, 8, 16):           # the shuffles, h < W
            if h < W:
                strand = np.stack([strand[s] + strand[s ^ h]
                                   for s in range(S)])
        w = strand[::W]                       # one row a warp
        part = ((w[0] + w[1]) + (w[2] + w[3])) + ((w[4] + w[5])
                                                  + (w[6] + w[7]))
        out = out + part
    return out[None]


@pytest.mark.parametrize("n,m,r", [(700, 3000, 3), (1100, 5000, 32),
                                   (70, 900, 40), (2049, 3, 1)])
def test_k13_order_is_the_kernel_loops(n, m, r):
    """``gather_rowsum_order`` bit for bit against the kernel's loops, over
    several chunks and partial ones, with an infinity and a NaN in rows no
    index names (they add nothing, as in the gather) and indices outside
    [0, N) (ignored)."""
    rng = np.random.default_rng(r)
    Y = rng.standard_normal((n, r)).astype(np.float32)
    idx = rng.integers(0, n // 2, size=m).astype(np.int32)
    Y[n - 1, 0], Y[n - 2, -1] = np.inf, np.nan
    with_bad = np.concatenate([idx, np.int32([-1, n, n + 5])])
    want = _k13_loops(Y, with_bad)
    assert _bits_equal(K.gather_rowsum_order(Y, with_bad).numpy(), want)
    assert _bits_equal(K.gather_rowsum_order(Y, idx).numpy(), want)
    assert np.all(np.isfinite(want))


@pytest.mark.parametrize("n,m,r", [(8192, 262144, 32), (8192, 262144, 8),
                                   (8192, 262144, 64), (100000, 20000, 32),
                                   (300, 10, 17), (50, 0, 3), (1, 5000, 32),
                                   (60000, 1000000, 16),
                                   (16384, 262144, 32), (32768, 262144, 32),
                                   (49152, 262144, 32), (49153, 262144, 32)])
def test_k13_plan_choice(n, m, r):
    """The counts plan exactly where its bytes, 4 (M + N (R + 2)), are
    fewer than the gather's, 4 M (R + 1); every plan listed once, the
    planned first, the shared histogram only where N fits, planned where a
    block's indices are at least N / 16 as well."""
    plans = K.k13_plans(n, m, r)
    plan = K.k13_plan(n, m, r)
    assert plans[0] == plan and len(set(plans)) == len(plans)
    assert plan.counts == (m + n * (r + 2) < m * (r + 1))
    assert K.K13Plan(False) in plans
    smem = [p for p in plans if p.smem]
    assert len(smem) == (1 if n <= K.K13_MAX_SMEM_BINS else 0)
    assert len(plans) == 2 + len(smem)
    assert not plan.counts or plan.smem == (
        n <= K.K13_MAX_SMEM_BINS
        and n * K.k13_grid(n, m, r) <= K.K13_SMEM_RATIO * m)
    assert sorted(p.mode for p in plans) == sorted({p.mode for p in plans})


@pytest.mark.parametrize("r", [1, 2, 3, 8, 17, 32, 33, 200, 256])
@pytest.mark.parametrize("n,m", [(1, 0), (8192, 262144), (100000, 20000),
                                 (5000, 10 ** 7)])
def test_k13_grid_and_chunks(n, m, r):
    """A chunk is 8 rows a strand of 256 / L strands (L = min(32,
    next_pow2(R)) lanes, at most 8 columns a lane); the counts plan's grid
    holds a block a chunk or a block a ``K13_HIST`` indices, at most
    ``K13_MAX_BLOCKS``, at least one block."""
    lanes = K.k13_lanes(r)
    assert lanes in (1, 2, 4, 8, 16, 32) and -(-r // lanes) <= 8
    assert lanes >= min(r, 32) and (lanes == 1 or lanes // 2 < r)
    rows = K.k13_chunk_rows(r)
    assert rows == 8 * (256 // lanes)
    chunks = -(-n // rows)
    grid = K.k13_grid(n, m, r)
    assert 1 <= grid <= K.K13_MAX_BLOCKS
    assert grid == min(K.K13_MAX_BLOCKS, max(chunks, -(-m // K.K13_HIST)))


def _k13_gather_loops(Y, idx):
    """The gather plan at R = 32 (a warp a row, no shuffle) in float32:
    warp w of block b adds rows idx[b tile + w + 8 t] in order, the block
    its 8 warps in order, the combine the blocks in order."""
    blocks, tile = K.gather_rowsum_grid(idx.size)
    rows = Y[idx].reshape(blocks, tile // 8, 8, Y.shape[1])
    acc = np.zeros((blocks, 8, Y.shape[1]), np.float32)
    for t in range(tile // 8):
        acc = acc + rows[:, t]
    part = np.zeros((blocks, Y.shape[1]), np.float32)
    for w in range(8):
        part = part + acc[:, w]
    out = np.zeros(Y.shape[1], np.float32)
    for row in part:
        out = out + row
    return out


@pytest.mark.parametrize("kind", ["uniform", "equal", "zipf"])
def test_k13_gather_bound_holds_for_the_gather_order(kind):
    """``k13_gather_bound`` bounds the gather plan's float32 sum at the
    probe's defaults, also on the skewed index sets."""
    from ltr_lowrank_sdp_torch.scripts.gather_probe import (probe_inputs,
                                                            skewed_indices)

    Y, idx = probe_inputs(8192, 262144, 32, "cpu", seed=5)
    if kind != "uniform":
        idx = skewed_indices(8192, 262144, kind, "cpu", seed=5)
    Y, idx = Y.numpy(), idx.numpy()
    exact = Y.astype(np.float64)[idx].sum(0)
    err = np.abs(_k13_gather_loops(Y, idx) - exact).max()
    assert 0 < err <= K.k13_gather_bound(Y, idx)


def test_ptxas_usage_names_k13s_kernels(monkeypatch):
    """K13's kernels by kind and template arguments (columns a lane, the
    shared histogram), from ``-Xptxas -v`` output."""
    def entry(name, regs):
        return [f"ptxas info    : Compiling entry function '_ZN54_GLOBAL__N_"
                f"_3477fede_16_gather_rowsum_cu_063ce5ca{name}' for 'sm_90a'",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads",
                f"ptxas info    : Used {regs} registers, used 1 barriers"]
    log = "\n".join(
        entry("18counts_hist_kernelILb1EEEvPKiiiPi", 20)
        + entry("18counts_pass_kernelILi1EEEvPKfPiiiiPfPjS3_", 40)
        + entry("26gather_rowsum_tiles_kernelILi1EEEvPKfPKiiiiiPf", 30))
    monkeypatch.setattr(K.KERNELS["gather_rowsum"], "build_log", log)
    assert K.ptxas_usage("gather_rowsum") == {
        ("hist", "-", (1,)): (20, 0, 0),
        ("pass", "-", (1,)): (40, 0, 0), ("tiles", "-", (1,)): (30, 0, 0)}
