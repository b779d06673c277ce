"""The port's rank-schedule predictor against the JAX package's, module by
module and whole, on the CPU.

Every module is built in both packages at a small width; the JAX module's
initial parameters go through ``params_from_flax`` into the port's module,
and the same numpy inputs (from a seed) go through both.  On the CPU the GATv2
layer and the poolings run through the plain versions of K9 and K10, which
are also held directly against the JAX ``segment_softmax`` / ``segment_sum``
/ ``segment_max`` they replace.  The checkpoint reader is held against
``flax.serialization.msgpack_restore`` on the three checkpoints of
``runs/``, the writer byte for byte against ``flax.serialization.to_bytes``,
and the whole ``predict`` of ``runs/r5_theta`` against the JAX package's on
two dataset graphs; a checkpoint the port writes loads in the JAX package
and predicts its schedule.  ``init_params`` draws every leaf from the
distribution Flax's initialiser gives it, and the decoder's teacher-forced
modes match the JAX decoder with the JAX coins injected.

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


@pytest.mark.parametrize("heads,ch", [(2, 16), (4, 12), (4, 24), (2, 48)],
                         ids=["32=2x16", "48=4x12", "96=4x24", "96=2x48"])
def test_gatv2_and_pooling_gradients_at_tuner_widths(heads, ch):
    """One GATv2 layer and the three poolings of its output at widths the
    tuner samples (``tune.py:24-27``; channel counts that are not powers of
    two), forward and gradients in float64 against ``jax.grad`` of the JAX
    layers: the loss to 1e-12, every parameter and both inputs to 1e-6 of
    the leaf's largest value (the two sides part by up to 5e-8 of a leaf at
    these widths, as in ``test_torch_train.py``).  On the CPU the port runs
    K9 / K10's plain versions and their plain backwards (K11 / K12); the
    checkpoint map takes every width."""
    rng = np.random.default_rng(heads * ch)
    n, e, d_in, d_e, hc = 40, 160, 12, 8, heads * ch
    x = rng.standard_normal((n, d_in))
    ei = _graph(rng, n, e)
    ea = rng.standard_normal((e, d_e))
    counts = (15, 25)
    batch = np.repeat(np.arange(2), counts)
    w_out = rng.standard_normal((n, hc))
    w_pool = rng.standard_normal((2, 3 * hc))
    gat = jax_gatv2.GATv2Conv(out_channels=ch, heads=heads, edge_dim=d_e)
    pool = jax_layers.AttentionPooling(hidden_dim=hc // 2)
    f64 = jax.tree_util.Partial(jax.tree.map, lambda p: p.astype(jnp.float64))
    gp = f64(jax.tree.map(lambda p: p + 0.1 if p.ndim == 1 else p, gat.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(ei),
        jnp.asarray(ea))))
    pp = f64(pool.init(jax.random.PRNGKey(2), jnp.zeros((n, hc)), batch, 2))

    def jax_loss(gp, pp, x, ea):
        h = gat.apply(gp, x, jnp.asarray(ei), ea)
        cnt = jax.ops.segment_sum(jnp.ones(n), batch, 2)
        mean = jax.ops.segment_sum(h, batch, 2) / cnt[:, None]
        mx = jax.ops.segment_max(h, batch, 2)
        att = pool.apply(pp, h, batch, 2)
        pooled = jnp.concatenate([mean, mx, att], axis=1)
        return jnp.sum(h * w_out) + jnp.sum(pooled * w_pool)

    want_loss, grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3))(
        gp, pp, jnp.asarray(x), jnp.asarray(ea))
    ours = _port(gatv2.GATv2Conv(d_in, ch, heads, d_e), gp).double()
    opool = _port(layers.AttentionPooling(hc, hc // 2), pp).double()
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(ea, requires_grad=True)
    seg = K.GraphSegments.from_counts(counts, "cpu")
    h = ours(xt, K.EdgeCSR.from_edge_index(torch.tensor(ei), n), et)
    pooled = K.graph_pool(seg, h, opool.score(h))
    loss = (torch.sum(h * torch.tensor(w_out))
            + torch.sum(pooled * torch.tensor(w_pool)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-12)
    want = {**{"gat." + k: v for k, v in checkpoint.params_from_flax(
        jax.tree.map(np.asarray, grads[0])).items()},
        **{"pool." + k: v for k, v in checkpoint.params_from_flax(
            jax.tree.map(np.asarray, grads[1])).items()},
        "x": torch.tensor(np.asarray(grads[2])),
        "edge_attr": torch.tensor(np.asarray(grads[3]))}
    got = {**{"gat." + k: p.grad for k, p in ours.named_parameters()},
           **{"pool." + k: p.grad for k, p in opool.named_parameters()},
           "x": xt.grad, "edge_attr": et.grad}
    assert set(got) == set(want)
    largest = max(float(v.abs().max()) for v in want.values())
    for k, w in want.items():
        err = float((got[k] - w.double()).abs().max())
        # the score bias's exact gradient is 0 (a softmax ignores a shift)
        scale = (largest if k == "pool.dense_1.bias"
                 else float(w.abs().max()))
        assert err <= 1e-6 * scale, (k, err)


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


# --------------------------------------------------------------------------- #
# training: checkpoint writer, initialisers, teacher-forced decode, dropout
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["r3", "r5", "r5_theta"])
def test_msgpack_writer_and_inverse_map(name):
    """params_to_flax inverts params_from_flax (whose leaves are float32:
    r3 was saved with float64 ``att`` leaves), and the writer gives
    flax.serialization.to_bytes's bytes, which for the float32 checkpoints
    are the file's own."""
    raw = (ROOT / "runs" / name / "model.msgpack").read_bytes()
    tree = checkpoint.read_flax_msgpack(raw)
    back = checkpoint.params_to_flax(checkpoint.params_from_flax(tree))
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_tree = jax.tree_util.tree_flatten_with_path(tree["params"])[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_tree]
    for (p, a), (_, b) in zip(flat_back, flat_tree):
        assert a.dtype == np.float32 and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b.astype(np.float32), err_msg=str(p))
    mine = checkpoint.write_flax_msgpack({"params": back})
    assert mine == serialization.to_bytes({"params": back})
    if all(b.dtype == np.float32 for _, b in flat_tree):
        assert mine == raw


def test_msgpack_writer_scalars_and_containers():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.array(2.5, np.float32),
                  "d": np.ones((300,), np.float64),
                  "e": np.zeros((0, 4), np.float32),
                  "f": np.arange(70000, dtype=np.int8)},
            "x" * 40: {str(i): np.full((i,), i, np.int64) for i in range(20)}}
    assert (checkpoint.write_flax_msgpack(tree)
            == serialization.msgpack_serialize(tree))
    got = checkpoint.read_flax_msgpack(checkpoint.write_flax_msgpack(tree))
    np.testing.assert_array_equal(got["b"]["f"], tree["b"]["f"])


def test_port_checkpoint_predicts_jax_schedule(r5_theta, tmp_path):
    jax_model, params, model = r5_theta
    checkpoint.save_checkpoint(str(tmp_path), model, model.cfg,
                               {"epoch": 3})
    _, got_params, cfg = jax_ckpt.load_model(str(tmp_path))
    assert cfg.to_dict() == model.cfg.to_dict()
    graph = _load_graph_file(str(ROOT / "dataset" / "proc" /
                                 "maxcut_n200_d4.npz"))
    n = graph["x"].shape[0]
    inputs = (jnp.asarray(graph["x"], jnp.float32),
              jnp.asarray(graph["edge_index"], jnp.int32),
              jnp.asarray(graph["edge_attr"], jnp.float32),
              jnp.zeros((n,), jnp.int32),
              jnp.asarray(graph["global_attr"], jnp.float32).reshape(1, -1),
              1)
    got = jax_model.apply(got_params, *inputs,
                          method=jax_net.RankSchedulePredictor.predict)
    want = jax_model.apply(params, *inputs,
                           method=jax_net.RankSchedulePredictor.predict)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    raw, L = checkpoint.predict_raw(model, graph)
    assert L == int(want[1][0])
    np.testing.assert_allclose(raw, np.asarray(want[0])[0],
                               rtol=PREDICT_RTOL)


def test_init_params_follows_flax_initialisers():
    """Every leaf of a fresh port model against the same leaf of a fresh
    JAX model at the repo's width: biases 0, LayerNorm scales 1, truncated
    normal kernels inside +-2 standard deviations with the same spread,
    orthogonal LSTM hidden kernels, att inside the Glorot bound."""
    cfg = jax_net.ModelConfig(hidden_dim=64, edge_dim=32, global_dim=32,
                              num_gnn_layers=3, num_heads=4,
                              decoder_hidden_dim=96, decoder_num_layers=2)
    z = np.zeros
    jparams = jax_net.RankSchedulePredictor(cfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        z((4, 16), np.float32), z((2, 6), np.int32), z((6, 5), np.float32),
        z((4,), np.int32), z((1, 17), np.float32), 1)
    want = checkpoint.params_from_flax(jax.tree.map(np.asarray, jparams))
    model = net.RankSchedulePredictor(net.ModelConfig(**cfg.to_dict()))
    net.init_params(model, torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith("bias") or (k.endswith("weight") and w.dim() == 1):
            assert torch.equal(g, w), k        # zeros, or LayerNorm ones
            continue
        if k.endswith("att"):
            limit = float(np.sqrt(6.0 / (w.shape[1] + w.shape[2])))
            assert float(g.abs().max()) <= limit
            assert float(w.abs().max()) <= limit
            continue
        if ".hh." in k:                        # four orthogonal blocks
            h = w.shape[1]
            for blk in (g.reshape(4, h, h), w.reshape(4, h, h)):
                eye = torch.eye(h).expand(4, h, h)
                assert torch.allclose(blk @ blk.transpose(1, 2), eye,
                                      atol=1e-5), k
            continue
        fan_in = w.shape[1]                    # (out, in), per gate block
        std = 1.0 / np.sqrt(fan_in)
        bound = 2.0 * std / .87962566103423978
        assert float(g.abs().max()) <= bound * (1 + 1e-6), k
        assert float(w.abs().max()) <= bound * (1 + 1e-6), k
        if w.numel() >= 2000:
            tol = 6.0 / np.sqrt(2.0 * w.numel())
            assert abs(float(g.std()) / std - 1) <= tol, k
            assert abs(float(w.std()) / std - 1) <= tol, k


@pytest.mark.parametrize("mode", ["coin", "teacher"])
def test_sequence_decoder_teacher_forced_matches_jax(mode):
    rng = np.random.default_rng(12)
    B, ctx, T = 4, 20, 8
    context = rng.standard_normal((B, ctx)).astype(np.float32)
    target = rng.integers(1, 40, (B, T)).astype(np.float32)
    mod = jax_layers.SequenceDecoder(context_dim=ctx, hidden_dim=16,
                                     num_layers=2, max_seq_len=T)
    params = mod.init(jax.random.PRNGKey(13), jnp.asarray(context),
                      jnp.asarray(target))
    tf_rng = jax.random.PRNGKey(14) if mode == "coin" else None
    want = mod.apply(params, jnp.asarray(context), jnp.asarray(target),
                     teacher_forcing_ratio=0.5, tf_rng=tf_rng)
    ours = _port(layers.SequenceDecoder(ctx, 16, 2, T), params)
    coins = None
    if mode == "coin":
        coins = torch.tensor(np.asarray(jax.vmap(
            lambda t: jax.random.uniform(jax.random.fold_in(tf_rng, t)))(
            jnp.arange(T))))
        assert (coins < 0.5).any() and (coins >= 0.5).any()
    with torch.no_grad():
        got = ours(torch.tensor(context), torch.tensor(target),
                   teacher_forcing_ratio=0.5, coins=coins)
    for a, b in zip(got, want):
        _close(a, b)


def test_dropout_keep_scale_is_flax_dropout():
    gen = torch.Generator().manual_seed(0)
    assert layers.keep_scale((5,), 0.0, gen, "cpu") is None
    assert torch.count_nonzero(layers.keep_scale((5,), 1.0, gen, "cpu")) == 0
    k = layers.keep_scale((200_000,), 0.15, gen, "cpu")
    values = torch.unique(k)
    assert values.numel() == 2 and values[0] == 0.0
    assert float(values[1]) == pytest.approx(1 / 0.85, rel=1e-6)
    assert abs(float((k > 0).float().mean()) - 0.85) < 0.005
    again = layers.keep_scale((200_000,), 0.15,
                              torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(k, again)                 # the generator decides
    x = torch.randn(50, 7)
    y = layers.dropout(x, 0.3, torch.Generator().manual_seed(1))
    assert torch.all((y == 0) | torch.isclose(y, x / 0.7))
    # a module in eval mode applies none
    block = layers.MLPBlock(7, 8, 3, dropout=0.5).eval()
    assert torch.equal(block(x, gen), block(x, gen))
