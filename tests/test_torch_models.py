"""The port's rank-schedule predictor against the JAX package's, module by
module and whole, on the CPU.

Every module is built in both packages at a small width; the JAX module's
initial parameters go through ``params_from_flax`` into the port's module,
and the same numpy inputs (from a seed) go through both.  On the CPU the GATv2
layer and the poolings run through the plain versions of K9 and K10, which
are also held directly against the JAX ``segment_softmax`` / ``segment_sum``
/ ``segment_max`` they replace.  The checkpoint reader is held against
``flax.serialization.msgpack_restore`` on the three checkpoints of
``runs/``, and the whole ``predict`` of ``runs/r5_theta`` against the JAX
package's on two dataset graphs.

Tolerances: modules rtol 1e-5 / atol 1e-6 (float32 on both sides, sums in
other orders); whole predictions 1e-4 relative on the raw schedule (three
GATv2 layers and 16 decoder steps compound the float32 rounding), the
rounded schedule and its length equal.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ltr_lowrank_sdp_tpu.data.loader import _load_graph_file
from ltr_lowrank_sdp_tpu.models import checkpoint as jax_ckpt
from ltr_lowrank_sdp_tpu.models import gatv2 as jax_gatv2
from ltr_lowrank_sdp_tpu.models import layers as jax_layers
from ltr_lowrank_sdp_tpu.models import net as jax_net
from ltr_lowrank_sdp_torch.models import checkpoint, gatv2, layers, net
from ltr_lowrank_sdp_torch.ops import kernels as K

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6
PREDICT_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's OpenMP workers spin after each parallel op and starve XLA's
    CPU threads in the same process (the JAX side ran 5x slower); the sizes
    here need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(module, jax_params):
    """The port's ``module`` with the JAX module's parameters."""
    module.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, jax_params)), strict=True)
    return module.eval()


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _graph(rng, n, e, loops=True, dup=True):
    """A random edge list with existing self-loops and duplicate edges."""
    ei = rng.integers(0, n, size=(2, e))
    if loops and e >= 2:
        ei[1, :2] = ei[0, :2]
    if dup and e >= 4:
        ei[:, -1] = ei[:, 2]
    return ei.astype(np.int64)


@pytest.mark.parametrize("name", ["r3", "r5", "r5_theta"])
def test_msgpack_reader_matches_flax(name):
    path = ROOT / "runs" / name / "model.msgpack"
    got = checkpoint.read_flax_msgpack(str(path))
    want = serialization.msgpack_restore(path.read_bytes())
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (p, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def test_msgpack_reader_scalars_and_containers():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.array(2.5), "d": [1, -3, 300, -70000, 2 ** 40],
                  "e": "x" * 40, "f": None, "g": True, "h": 1.5,
                  "i": np.zeros((0, 4), np.float32)}}
    got = checkpoint.read_flax_msgpack(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["a"].dtype == np.int32
    assert got["b"]["c"].shape == () and got["b"]["c"] == 2.5
    assert got["b"]["d"] == tree["b"]["d"]
    assert got["b"]["e"] == tree["b"]["e"] and got["b"]["f"] is None
    assert got["b"]["g"] is True and got["b"]["h"] == 1.5
    assert got["b"]["i"].shape == (0, 4)


def test_mlp_block():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    mod = jax_layers.MLPBlock(24, 12)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = _port(layers.MLPBlock(5, 24, 12), params)
    _close(ours(torch.tensor(x)), mod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("case", ["random", "no-edges", "two-heads"])
def test_gatv2_conv(case):
    rng = np.random.default_rng({"random": 1, "no-edges": 2,
                                 "two-heads": 3}[case])
    n, e, d_in, d_e = 11, 40, 12, 8
    heads, ch = (2, 8) if case == "two-heads" else (4, 16)
    if case == "no-edges":
        e = 0
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    ei = _graph(rng, n, e)
    ea = rng.standard_normal((e, d_e)).astype(np.float32)
    mod = jax_gatv2.GATv2Conv(out_channels=ch, heads=heads, edge_dim=d_e)
    args = (jnp.asarray(x), jnp.asarray(ei), jnp.asarray(ea))
    params = mod.init(jax.random.PRNGKey(4), *args)
    # the JAX layer's bias initialiser is zero: give the loop row a bias
    # to carry, so that the zero-edge fill is held too
    params = jax.tree.map(
        lambda p: p + 0.1 if p.ndim == 1 else p, params)
    want = mod.apply(params, *args)
    ours = _port(gatv2.GATv2Conv(d_in, ch, heads, d_e), params)
    K.reset_counts()
    got = ours(torch.tensor(x),
               K.EdgeCSR.from_edge_index(torch.tensor(ei), n),
               torch.tensor(ea))
    _close(got, want)
    assert K.counts()["gatv2_softmax_agg"] == (0, 1)


def test_edge_csr_keeps_duplicates_and_appends_loops():
    rng = np.random.default_rng(5)
    n, e = 9, 30
    ei = _graph(rng, n, e)
    g = K.EdgeCSR.from_edge_index(torch.tensor(ei), n)
    assert g.n_real == e and g.src.numel() == e + n
    ptr = g.indptr.long().numpy()
    assert ptr[0] == 0 and ptr[-1] == e + n
    src, erow = g.src.long().numpy(), g.erow.long().numpy()
    for i in range(n):
        rows = erow[ptr[i]:ptr[i + 1]]
        want = list(np.flatnonzero(ei[1] == i)) + [e]   # loops last
        assert rows.tolist() == want
        assert src[ptr[i]:ptr[i + 1]].tolist() == (
            ei[0, want[:-1]].tolist() + [i])


def test_k9_plain_matches_jax_segment_ops():
    rng = np.random.default_rng(6)
    n, e, heads, ch = 13, 50, 4, 16
    ei = _graph(rng, n, e)
    w_src, w_dst = (rng.standard_normal((n, heads * ch)).astype(np.float32)
                    for _ in range(2))
    we = rng.standard_normal((e, heads * ch)).astype(np.float32)
    we_loop = rng.standard_normal(heads * ch).astype(np.float32)
    att = rng.standard_normal((heads, ch)).astype(np.float32)
    # the reference: the JAX layer's own segment ops on the appended edges
    src = np.concatenate([ei[0], np.arange(n)])
    dst = np.concatenate([ei[1], np.arange(n)])
    we_all = np.concatenate([we, np.broadcast_to(we_loop, (n, heads * ch))])
    msg = (w_src[src] + w_dst[dst] + we_all).reshape(-1, heads, ch)
    scores = jnp.sum(jax.nn.leaky_relu(jnp.asarray(msg), 0.2) * att, -1)
    alpha = jax.vmap(lambda s: jax_gatv2.segment_softmax(s, dst, n),
                     in_axes=1, out_axes=1)(scores)
    want = jax.ops.segment_sum(
        (w_src[src].reshape(-1, heads, ch) * alpha[..., None]).reshape(
            -1, heads * ch), dst, n)
    g = K.EdgeCSR.from_edge_index(torch.tensor(ei), n)
    got = K.gatv2_softmax_agg_plain(
        g, *(torch.tensor(a) for a in (w_src, w_dst, we, we_loop, att)))
    _close(got, want)
    np.testing.assert_allclose(
        K.segment_softmax(torch.tensor(np.asarray(scores)),
                          torch.tensor(dst), n).numpy(),
        np.asarray(alpha), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("counts", [(5, 9, 4), (6, 0, 300, 2)],
                         ids=["three-graphs", "with-an-empty-graph"])
def test_k10_pooling_matches_jax(counts):
    """Mean / max pooling (``net.py:89-94``) and ``AttentionPooling`` with
    B graphs, through K10's plain version and the port's module."""
    rng = np.random.default_rng(sum(counts))
    B, N, D = len(counts), sum(counts), 16
    x = rng.standard_normal((N, D)).astype(np.float32)
    batch = np.repeat(np.arange(B), counts)
    seg = K.GraphSegments.from_batch(torch.tensor(batch), B)
    # chunks never span two graphs, an empty graph owns none
    assert seg.n_chunks == sum(-(-c // K.K10_CHUNK) for c in counts)
    ones = jnp.ones((N,), jnp.float32)
    cnt = jax.ops.segment_sum(ones, batch, B)
    x_mean = jax.ops.segment_sum(x, batch, B) / jnp.maximum(cnt, 1.0)[:, None]
    x_max = jax.ops.segment_max(x, batch, B)
    x_max = jnp.where(jnp.isfinite(x_max), x_max, 0.0)
    mod = jax_layers.AttentionPooling(hidden_dim=8)
    params = mod.init(jax.random.PRNGKey(7), jnp.asarray(x), batch, B)
    x_attn = mod.apply(params, jnp.asarray(x), batch, B)
    ours = _port(layers.AttentionPooling(D, 8), params)
    xt = torch.tensor(x)
    K.reset_counts()
    pooled = K.graph_pool(seg, xt, ours.score(xt))
    _close(pooled[:, :D], x_mean)
    _close(pooled[:, D:2 * D], x_max)
    _close(pooled[:, 2 * D:], x_attn)
    _close(ours(xt, seg), x_attn)
    assert K.counts()["graph_pool"] == (0, 2)
    # and K10's plain version against the JAX segment softmax directly
    score = rng.standard_normal(N).astype(np.float32)
    w = jax_gatv2.segment_softmax(jnp.asarray(score), batch, B)
    _close(K.graph_pool_plain(seg, xt, torch.tensor(score))[:, 2 * D:],
           jax.ops.segment_sum(w[:, None] * x, batch, B))


def test_lstm_stack_step():
    rng = np.random.default_rng(8)
    B, d_in, h, L = 3, 10, 16, 2
    x = rng.standard_normal((B, d_in)).astype(np.float32)
    carry = tuple((rng.standard_normal((B, h)).astype(np.float32),
                   rng.standard_normal((B, h)).astype(np.float32))
                  for _ in range(L))
    mod = jax_layers._LSTMStack(h, L)
    jcarry = jax.tree.map(jnp.asarray, carry)
    params = mod.init(jax.random.PRNGKey(9), jcarry, jnp.asarray(x))
    want_carry, want_out = mod.apply(params, jcarry, jnp.asarray(x))
    ours = _port(layers._LSTMStack(d_in, h, L), params)
    got_carry, got_out = ours(jax.tree.map(torch.tensor, carry),
                              torch.tensor(x))
    _close(got_out, want_out)
    for (c, hh), (wc, wh) in zip(got_carry, want_carry):
        _close(c, wc)
        _close(hh, wh)


def test_sequence_decoder_generate():
    rng = np.random.default_rng(10)
    B, ctx = 3, 20
    context = rng.standard_normal((B, ctx)).astype(np.float32)
    mod = jax_layers.SequenceDecoder(context_dim=ctx, hidden_dim=16,
                                     num_layers=2, max_seq_len=8)
    params = mod.init(jax.random.PRNGKey(11), jnp.asarray(context),
                      method=jax_layers.SequenceDecoder.generate)
    want = mod.apply(params, jnp.asarray(context),
                     method=jax_layers.SequenceDecoder.generate)
    ours = _port(layers.SequenceDecoder(ctx, 16, 2, 8), params)
    with torch.no_grad():
        got = ours.generate(torch.tensor(context))
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[2], want[2])


@pytest.fixture(scope="module")
def r5_theta():
    jax_model, params, cfg = jax_ckpt.load_model(str(ROOT / "runs/r5_theta"))
    model, ours_cfg = checkpoint.load_model(str(ROOT / "runs/r5_theta"),
                                            device="cpu")
    assert ours_cfg.to_dict() == cfg.to_dict()
    return jax_model, params, model


def test_checkpoint_conversion_and_count(r5_theta):
    _, params, model = r5_theta
    assert net.count_parameters(model) == jax_net.count_parameters(params)
    from_jax = checkpoint.params_from_flax(jax.tree.map(np.asarray, params))
    state = model.state_dict()
    assert set(from_jax) == set(state)
    for k, v in from_jax.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("name", ["maxcut_n200_d4", "theta_n95_d23"])
def test_predict_matches_jax(r5_theta, name):
    jax_model, params, model = r5_theta
    graph = _load_graph_file(str(ROOT / "dataset" / "proc" / f"{name}.npz"))
    n = graph["x"].shape[0]
    sched, lengths = jax_model.apply(
        params, jnp.asarray(graph["x"], jnp.float32),
        jnp.asarray(graph["edge_index"], jnp.int32),
        jnp.asarray(graph["edge_attr"], jnp.float32),
        jnp.zeros((n,), jnp.int32),
        jnp.asarray(graph["global_attr"], jnp.float32).reshape(1, -1), 1,
        method=jax_net.RankSchedulePredictor.predict)
    want_raw = np.asarray(sched)[0]
    want_len = int(np.asarray(lengths)[0])
    K.reset_counts()
    raw, L = checkpoint.predict_raw(model, graph)
    assert K.counts()["gatv2_softmax_agg"] == (0, 3)
    assert K.counts()["graph_pool"] == (0, 1)
    assert L == want_len
    np.testing.assert_allclose(raw, want_raw, rtol=PREDICT_RTOL)
    want = np.maximum(np.round(want_raw[:L]), 1).astype(int).tolist()
    assert checkpoint.predict_schedule_for_graph(model, graph) == (want, L)
    assert net.get_valid_schedule(raw[None], [L]) == [want]
