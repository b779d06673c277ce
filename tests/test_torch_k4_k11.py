"""K4 (``sym_contract_sum``) and K11 (``gatv2_softmax_agg_bwd``) as they
are laid out for the card: K4's host plan (lane group, chunks, grid) and the
launches the source instantiates, K11's source CSR with each slot's
destination and its scratch size, on the CPU; on the GPU (tests marked
``cuda``, skipped elsewhere) each kernel against its plain version and
bitwise against itself across plans, calls, a CUDA-graph replay and two
graphs captured on one stream replayed at once.  Run those there with

    python -m pytest --noconftest tests/test_torch_k4_k11.py -m cuda

Tolerances: K4 1e-12 relative in float64 and 1e-10 of the sum of |terms|
in float32 (its products and sums are float64 either way; the plain version
sums in another order); K11 ``GNN_TOL`` = 1e-5 of each output's largest
value against the plain backward evaluated in float64 on the kernel's own
inputs, as ``chip_smoke.py`` holds it.  The plain versions' parity with the
JAX package is in ``test_torch_isolation.py`` (K4), ``test_torch_coneops.py``
and ``test_torch_train.py`` (K11).
"""

import re

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.testing import (captured_kernel_nodes,
                                          delaunay_maxcut_adjacency)

cuda = pytest.mark.cuda

RTOL = 1e-12
F32_TOL = 1e-10
GNN_TOL = 1e-5
K4_RANKS = [1, 2, 7, 8, 19, 20, 141]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    K.build_kernels()
    return torch.device("cuda", torch.cuda.current_device())


# --------------------------------------------------------------------------- #
# K4: the host plan
# --------------------------------------------------------------------------- #


def _k4_instantiated():
    src = (K.CSRC_DIR / "sym_contract_sum.cu").read_text()
    return {tuple(int(x) for x in m.split(","))
            for m in re.findall(r"K4_CASE\((\d+, \d+)\)", src)}


CAP = 132 * 4        # an H100's SMs times 4 resident blocks, for example


@pytest.mark.parametrize("r", [2, 141])
@pytest.mark.parametrize("nnz", [0, 1, 255, 256, 257, CAP * 256,
                                 CAP * 256 + 1])
def test_k4_plan_is_a_function_of_nnz_and_r(nnz, r):
    """The lane group is :func:`lane_group`'s; the chunks count 256 entries
    from entry 0; the grid is a block a chunk up to the cap (the blocks that
    fit the card at once), and at least one block (nnz = 0 writes 0)."""
    plan = K.k4_plan(nnz, r, CAP)
    assert (plan.g, plan.cpl) == K.lane_group(r)
    assert plan.chunks == -(-nnz // 256) and K.K4_CHUNK == 256
    assert 1 <= plan.grid <= CAP
    assert plan.grid == max(1, plan.chunks) or plan.grid == CAP < plan.chunks
    assert K.k4_plan(nnz, r, CAP // 2).grid == min(plan.grid, CAP // 2)
    assert plan.describe().endswith(f"grid={plan.grid}")


@pytest.mark.parametrize("nnz", [0, 100, 3_000, 16_384, 65_536, 524_800])
def test_every_k4_plan_is_a_launch_the_kernel_takes(nnz):
    """The sweep's plans: the planned one first, each once, an instantiated
    lane group, the same chunks and at least one block; one block walks
    every chunk, and a grid past the chunks is never asked for."""
    for r in (2, 8, 20, 141):
        plans = K.k4_plans(nnz, r, CAP)
        assert plans[0] == K.k4_plan(nnz, r, CAP)
        assert len(set(plans)) == len(plans)
        assert min(p.grid for p in plans) == 1
        for p in plans:
            assert (p.g, p.cpl) in _k4_instantiated()
            assert 1 <= p.grid <= max(1, p.chunks)
            assert p.chunks == plans[0].chunks


def test_every_k4_lane_group_is_instantiated():
    inst = _k4_instantiated()
    assert len(inst) == 13
    for r in range(1, 700):
        assert K.lane_group(r) in inst


# --------------------------------------------------------------------------- #
# K11: the source CSR and the scratch
# --------------------------------------------------------------------------- #


def _graph(case, n=300):
    rng = np.random.default_rng(len(case))
    e = {"no-edges": 0, "one": 1}.get(case, 2000)
    ei = rng.integers(0, n, size=(2, e))
    if case == "hub":
        ei[1, :100] = 7
        ei[0, 100:200] = 9
    if e > 20:
        ei[1, :10] = ei[0, :10]            # existing self-loops
        ei[:, -5:] = ei[:, :5]             # repeated edges
    return K.EdgeCSR.from_edge_index(torch.tensor(ei), n)


@pytest.mark.parametrize("case", ["random", "hub", "no-edges", "one"])
def test_by_src_covers_every_slot_once_in_slot_order_with_its_destination(
        case):
    g = _graph(case)
    src_ptr, src_slot, src_dst = g.by_src
    assert src_ptr.dtype == src_slot.dtype == src_dst.dtype == torch.int32
    assert src_ptr.numel() == g.n + 1 and src_slot.numel() == g.n_slots
    assert sorted(src_slot.tolist()) == list(range(g.n_slots))
    src = g.src.long()
    dst = g.dst_ids
    ptr = src_ptr.tolist()
    assert ptr[0] == 0 and ptr[-1] == g.n_slots
    for j in range(g.n):
        slots = src_slot[ptr[j]:ptr[j + 1]].long()
        assert torch.all(src[slots] == j)
        assert torch.all(slots[1:] > slots[:-1])        # slot order
        assert torch.equal(src_dst[ptr[j]:ptr[j + 1]].long(), dst[slots])


@pytest.mark.parametrize("heads,ch", [(4, 16), (2, 16), (4, 12), (4, 20),
                                      (2, 48), (4, 24), (4, 64), (3, 32),
                                      (1, 1)])
def test_k11_scratch_is_a_few_words_a_slot(heads, ch):
    """Per slot and head two floats, per slot the plan's words of msg signs,
    and the destination pass's block partials: no (E', H C) row.  At the
    training shape (MC_600x600_r5: E' = 2,564,916 slots, n = 85,080, 4
    heads of 16 channels) that is under a fifth of E' H C 4 bytes."""
    n, slots = 85_080, 2_564_916
    words = K.k11_plan(heads, ch).words
    blocks = K.k11_max_blocks(n, CAP)
    assert blocks == min(-(-n // 8), CAP) and K.k11_max_blocks(9, CAP) == 2
    scratch = K.k11_scratch(slots, n, heads, ch, blocks, "meta")
    assert [tuple(t.shape) for t in scratch] == [
        (slots, heads, 2), (slots, words), (blocks, 2 * heads * ch)]
    got = sum(t.nbytes for t in scratch)
    assert got == slots * (8 * heads + 4 * words) + blocks * 2 * heads \
        * ch * 8
    if (heads, ch) == (4, 16):
        assert got < slots * heads * ch * 4 / 5
    assert sum(t.nbytes for t in K.k11_scratch(0, 0, heads, ch, 1,
                                               "meta")) == 0


def _k11_instantiated():
    src = (K.CSRC_DIR / "gatv2_softmax_agg_bwd.cu").read_text()
    return {tuple(int(x) for x in m.split(","))
            for m in re.findall(r"K11_CASE\((\d+, \d+)\)", src)}


def test_every_k11_plan_is_instantiated_and_covers_its_row():
    """For every width K9 takes: the plan's (P, S) is a case of the source's
    dispatch, S sub-warps divide the head's lanes, P channels a lane of the
    sub-warp's head lanes reach the head's channels, at most 8, and the sign
    words hold P fields of 32 / S bits."""
    inst = _k11_instantiated()
    assert len(inst) == 16
    seen = set()
    for heads in range(1, 33):
        for ch in range(1, 257):
            try:
                lph, per_lane = K.gatv2_lanes(heads, ch)
            except ValueError:
                continue
            plan = K.k11_plan(heads, ch)
            seen.add((plan.p, plan.s))
            assert (plan.p, plan.s) in inst
            assert lph % plan.s == 0 and plan.p <= 8
            hw = lph // plan.s
            assert plan.p * hw >= ch and (plan.p - 1) * hw < ch
            assert plan.s == (min(lph, 4) if per_lane == 1 else
                              min(lph, 2) if per_lane == 2 else 1)
            assert plan.words == -(-plan.p * 32 // plan.s // 32)
    assert seen <= inst
    assert K.k11_plan(4, 16).describe() == "S=2 P=4"


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _k4_entries(case, n):
    """(rows, cols, coef) of an upper triangle: HALLaR's C (the identity of
    matrix completion plus a few entries), a dense C, or a MaxCut
    Laplacian's, coef doubled off the diagonal."""
    rng = np.random.default_rng(n)
    if case == "hallar":
        rows = np.concatenate([np.arange(n), rng.integers(0, n // 2, 50)])
        cols = np.concatenate([np.arange(n), rng.integers(n // 2, n, 50)])
        vals = np.concatenate([np.ones(n), rng.standard_normal(50)])
    elif case == "dense":
        rows, cols = np.triu_indices(n)
        vals = rng.standard_normal(rows.size)
    else:
        A = delaunay_maxcut_adjacency(n, seed=3).tocoo()
        keep = A.row < A.col
        deg = np.asarray(A.sum(axis=1)).ravel()
        rows = np.concatenate([np.arange(n), A.row[keep]])
        cols = np.concatenate([np.arange(n), A.col[keep]])
        vals = np.concatenate([0.25 * deg, -0.25 * A.data[keep]])
    coef = np.where(rows != cols, 2.0, 1.0) * vals
    return rows, cols, coef


def _k4_inputs(case, n, r, dev, dtype):
    rows, cols, coef = _k4_entries(case, n)
    rng = np.random.default_rng(r)
    return (torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(cols, dtype=torch.int32, device=dev),
            torch.tensor(coef, dtype=dtype, device=dev),
            *(torch.tensor(rng.standard_normal((n, r)), dtype=dtype,
                           device=dev) for _ in range(2)))


K4_SIZES = {"hallar": 3000, "dense": 300, "maxcut": 4096}


def _k4_acc32_loop(rows, cols, coef, U, V):
    """K4's float32-summing instance written out lane by lane as the source
    reads (numpy float32 scalars, each product and sum rounded): entries of
    a chunk's warp by steps of 32 / G, a lane's columns in passes, coef times
    a lane's column sum added in step order, the xor tree over 32 lanes, the
    balanced tree over 8 warps, then chunks by thread and the same trees."""
    f = np.float32
    same = U is V
    nnz, r = len(rows), U.shape[1]
    g, cpl = K.lane_group(r)
    chunks = -(-nnz // 256)

    def tree(v):
        while len(v) > 1:
            v = [f(v[i] + v[i + len(v) // 2]) for i in range(len(v) // 2)]
        return v[0]

    def warps(ws):
        return f(f(f(ws[0] + ws[1]) + f(ws[2] + ws[3]))
                 + f(f(ws[4] + ws[5]) + f(ws[6] + ws[7])))

    part = []
    for c in range(chunks):
        ws = []
        for w in range(8):
            lanes = []
            for lane in range(32):
                q, lig = divmod(lane, g)
                acc = f(0)
                for step in range(g):
                    e = c * 256 + w * 32 + step * (32 // g) + q
                    if e >= nnz:
                        continue
                    i, j, d = rows[e], cols[e], f(0)
                    for c0 in range(0, r, g * cpl):
                        for k in range(cpl):
                            col = c0 + lig + g * k
                            if col >= r:
                                continue
                            if same:
                                d = f(d + f(U[i, col] * U[j, col]))
                            else:
                                d = f(d + f(f(U[i, col] * V[j, col])
                                            + f(U[j, col] * V[i, col])))
                    acc = f(acc + f(coef[e] * (d if same else f(f(0.5) * d))))
                lanes.append(acc)
            ws.append(tree(lanes))
        part.append(warps(ws))
    threads = []
    for t in range(256):
        acc = f(0)
        for cc in range(t, chunks, 256):
            acc = f(acc + part[cc])
        threads.append(acc)
    return warps([tree(threads[w * 32:(w + 1) * 32]) for w in range(8)])


@pytest.mark.parametrize("nnz,r,same", [
    (0, 3, True), (1, 5, False), (600, 1, True), (600, 2, False),
    (600, 7, True), (600, 19, False), (600, 40, True), (300, 300, True),
    (66000, 1, True)])
def test_k4_acc32_plain_follows_the_kernel_order(nnz, r, same):
    """The plain float32-summing K4 (HALLaR's float32 ``CX``) gives the bits
    of the kernel's order written out lane by lane, so the CPU and the card
    agree to the bit: one chunk and several, a lane group of 1 to 32, two
    column passes (r = 300), more than 256 chunks (the last block's walk)."""
    rng = np.random.default_rng(nnz + r)
    n = 50
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    coef = (rng.standard_normal(nnz) * 10.0 ** rng.integers(
        -3, 3, nnz)).astype(np.float32)
    U = rng.standard_normal((n, r)).astype(np.float32)
    V = U if same else rng.standard_normal((n, r)).astype(np.float32)
    want = _k4_acc32_loop(rows, cols, coef, U, V)
    tu = torch.tensor(U)
    got = K.sym_contract_sum_plain(torch.tensor(rows), torch.tensor(cols),
                                   torch.tensor(coef), tu,
                                   tu if same else torch.tensor(V),
                                   acc32=True)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.float32(want).tobytes()


@cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("r", K4_RANKS)
@pytest.mark.parametrize("case", ["hallar", "dense", "maxcut"])
def test_k4_acc32_gives_the_cpu_plain_bits(dev, case, r, same):
    """K4's float32-summing instance on the card and its plain version on
    the CPU give the same bits, at every grid of the plan."""
    rows, cols, coef, U, V = _k4_inputs(case, K4_SIZES[case], r, dev,
                                        torch.float32)
    V = U if same else V
    Uc = U.cpu()
    want = K.sym_contract_sum_plain(rows.cpu(), cols.cpu(), coef.cpu(), Uc,
                                    Uc if same else V.cpu(), acc32=True)
    for plan in K.k4_plans(rows.numel(), r, K.k4_cap(U, same, True)):
        got = K.sym_contract_sum_with(plan, rows, cols, coef, U, V, True)
        assert torch.equal(got.cpu(), want), plan.describe()


@cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("r", K4_RANKS)
@pytest.mark.parametrize("case", ["hallar", "dense", "maxcut"])
def test_k4_matches_plain(dev, case, r, dtype):
    rows, cols, coef, U, V = _k4_inputs(case, K4_SIZES[case], r, dev, dtype)
    before = K.KERNELS["sym_contract_sum"].launches
    for a, b in ((U, V), (U, U)):
        got = K.sym_contract_sum(rows, cols, coef, a, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.float64 and got.shape == ()
        want = K.sym_contract_sum_plain(rows, cols, coef.double(),
                                        a.double(), a.double() if b is a
                                        else b.double())
        if dtype == torch.float64:
            assert abs(float(got - want)) <= RTOL * abs(float(want))
        else:
            ri, ci = rows.long(), cols.long()
            terms = coef.double() * torch.sum(
                a.double()[ri] * b.double()[ci], dim=-1)
            scale = float(terms.abs().sum())
            assert abs(float(got - want)) <= F32_TOL * scale
    assert K.KERNELS["sym_contract_sum"].launches == before + 2


@cuda
@pytest.mark.parametrize("r", [2, 7, 20, 141])
@pytest.mark.parametrize("case", ["hallar", "dense", "maxcut"])
def test_k4_same_bits_across_plans_calls_and_graph_replays(dev, case, r):
    rows, cols, coef, U, V = _k4_inputs(case, K4_SIZES[case], r, dev,
                                        torch.float64)
    for a, b in ((U, V), (U, U)):
        want = K.sym_contract_sum(rows, cols, coef, a, b)
        assert torch.equal(K.sym_contract_sum(rows, cols, coef, a, b), want)
        for plan in K.k4_plans(rows.numel(), r, K.k4_cap(a, b is a)):
            got = K.sym_contract_sum_with(plan, rows, cols, coef, a, b)
            assert torch.equal(got, want), plan.describe()
    # captured on a side stream after an eager warm-up there, as HALLaR's
    # run_fista does, and replayed on the calling stream
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        K.sym_contract_sum(rows, cols, coef, U, U)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        static = K.sym_contract_sum(rows, cols, coef, U, U)
    want = K.sym_contract_sum(rows, cols, coef, U, U)
    first = U.clone()
    for scale in (1.0, -2.0, 0.75):
        U.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, K.sym_contract_sum(rows, cols, coef, U, U))
    U.copy_(first)
    graph.replay()
    assert torch.equal(static, want)


@cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("case", ["hallar", "dense", "maxcut"])
def test_k4_graphs_captured_on_one_stream_replay_at_once(dev, case, same):
    """Two graphs captured on one stream, each with its own inputs, replayed
    at the same time on two streams while eager calls run on the capture
    stream: every call has a ticket of its own, so each result keeps its
    bits."""
    ins = [_k4_inputs(case, K4_SIZES[case], 7, dev, torch.float64)
           for _ in range(2)]
    ins[1][3].mul_(-0.5)

    def call(rows, cols, coef, U, V):
        return K.sym_contract_sum(rows, cols, coef, U, U if same else V)

    want = [call(*x) for x in ins]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call(*ins[0])
    graphs, static = [], []
    for x in ins:
        graphs.append(torch.cuda.CUDAGraph())
        with torch.cuda.graph(graphs[-1], stream=side):
            static.append(call(*x))
    two = [torch.cuda.Stream(dev) for _ in graphs]
    for s in two + [side]:
        s.wait_stream(torch.cuda.current_stream(dev))
    eager = []
    for _ in range(50):
        for g, s in zip(graphs, two):
            with torch.cuda.stream(s):
                g.replay()
        with torch.cuda.stream(side):
            eager.append(call(*ins[1]))
    torch.cuda.synchronize()
    assert torch.equal(static[0], want[0]) and torch.equal(static[1], want[1])
    assert all(torch.equal(e, want[1]) for e in eager)


@cuda
@pytest.mark.parametrize("case", ["hallar", "dense", "maxcut"])
def test_k4_is_one_kernel_a_call(dev, case):
    """One device kernel a call, counted as the kernel nodes of a CUDA
    graph captured from one call (the scratch comes from the warm-up)."""
    rows, cols, coef, U, V = _k4_inputs(case, K4_SIZES[case], 20, dev,
                                        torch.float64)
    for a, b in ((U, U), (U, V)):
        assert captured_kernel_nodes(
            lambda: K.sym_contract_sum(rows, cols, coef, a, b)) == 1


def _k11_case(heads, ch, dev, keep, n=2000, e=40_000, seed=0):
    rng = np.random.default_rng(seed + heads * 100 + ch)
    ei = rng.integers(0, n, size=(2, e))
    ei[1, :300] = 11                         # a hub of 300 incoming edges
    ei[1, :10] = ei[0, :10]
    g = K.EdgeCSR.from_edge_index(torch.tensor(ei, device=dev), n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    hc = heads * ch

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    args = (rnd(n, hc), rnd(n, hc), rnd(e, hc), rnd(hc),
            rnd(heads, ch, scale=0.5))
    kp = None
    if keep:
        u = torch.rand((g.n_slots, heads), generator=gen, device=dev)
        kp = (u < 0.9).float() / 0.9
    return g, args, kp


@cuda
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("heads,ch", [(4, 16), (2, 16), (4, 12), (4, 20),
                                      (2, 48), (4, 24), (4, 64)])
def test_k11_matches_float64_plain_at_the_width_phase_shapes(dev, heads, ch,
                                                             keep):
    """K11 on K9's lse, out and scores (the training path's inputs) against
    the plain backward in float64 on the same inputs."""
    g, args, kp = _k11_case(heads, ch, dev, keep)
    sc = torch.empty((g.n_slots, heads), device=dev)
    out, lse = K._gatv2_forward(g, *args, kp, True, scores=sc)
    dout = torch.randn(out.shape, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    got = K.gatv2_softmax_agg_bwd(g, *args, kp, lse, out, dout, sc)
    again = K.gatv2_softmax_agg_bwd(g, *args, kp, lse, out, dout, sc)
    torch.cuda.synchronize()
    want = K.gatv2_softmax_agg_bwd_plain(
        g, *(t.double() for t in args), None if kp is None else kp.double(),
        lse.double(), out.double(), dout.double(), sc.double())
    floor = 1e-6 * max(float(w.abs().max()) for w in want)
    for a, b, c in zip(got, want, again):
        assert a.shape == b.shape and a.dtype == torch.float32
        scale = max(float(b.abs().max()), floor)
        assert float((a.double() - b).abs().max()) <= GNN_TOL * scale
        assert torch.equal(a, c)                    # no atomics on values


def test_ptxas_usage_reads_k4_and_k11_instantiations(monkeypatch):
    """K4's registers keyed by value type and (U is V, G, CPL), K11's by
    pass and channels per lane (a float32 kernel: no value type)."""
    k4 = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119sym_"
        "contract_kernelIdLb1ELi8ELi1EEEvPKiS2_PKT_S5_S5_iiiPdPjS6_' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 132 bytes smem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119sym_"
        "contract_kernelIfLb0ELi32ELi5EEEvPKiS2_PKT_S5_S5_iiiPdPjS6_' for "
        "'sm_90a'",
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers, 132 bytes smem"])
    k11 = "\n".join([
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__28cc0f77_"
        "24_gatv2_softmax_agg_bwd_cu_d5037a5d20gatv2_bwd_dst_kernelILi2EEEvPKi"
        "S2_S2_PKfS4_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 86 registers, used 1 barriers, 8192 bytes smem",
        "ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__28cc0f77_"
        "24_gatv2_softmax_agg_bwd_cu_d5037a5d20gatv2_bwd_src_kernelILi8EEEvPKi"
        "S2_S2_PK6float2' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 2048 bytes smem"])
    monkeypatch.setattr(K.KERNELS["sym_contract_sum"], "build_log", k4)
    monkeypatch.setattr(K.KERNELS["gatv2_softmax_agg_bwd"], "build_log", k11)
    assert K.ptxas_usage("sym_contract_sum") == {
        ("main", "f64", (1, 8, 1)): (40, 0, 0),
        ("main", "f32", (0, 32, 5)): (64, 8, 4)}
    assert K.ptxas_usage("gatv2_softmax_agg_bwd") == {
        ("dst", "-", (2,)): (86, 0, 0), ("src", "-", (8,)): (72, 0, 0)}
