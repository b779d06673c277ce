"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs (from a seed or from the dataset) go through the JAX
function and its port:

* ``rank_schedule_loss``, every component, on cases with under-prediction,
  masks and rows that pad the graph axis (float64 on both sides, 1e-6
  relative plus 1e-12 absolute: the same formulas summed in another order);
* ``collate`` / ``iterate_batches``: the same batch membership, graph-axis
  arrays, real nodes and edges, and the JAX envelopes; the self-loops' edge
  feature that the port derives from the envelope equals the one
  ``GATv2Conv`` averages over the padded JAX arrays, to 1e-6 (float64);
* the teacher-forced forward of a small predictor (2 GATv2 layers x 2
  heads, hidden 16) on a collated dataset batch, dropout 0 and the JAX
  coins injected (``fold_in(tf_rng, t)``), to 1e-5 (float32 on both sides);
* the gradients of the loss: the port's autograd, through the plain K9 / K10
  backwards, against ``jax.value_and_grad``, every leaf through
  ``params_from_flax`` to 1e-4 of its largest value.  Both sides run in
  float64 here: in float32 the gradients of the leaves behind a softmax
  (``lin_dst``, ``lin_edge``, the edge encoder) are sums that cancel to a
  thousandth of their terms, and two float32 programs that sum in other
  orders part there by 1e-3 of the leaf (they agree to 1e-5 of the model's
  largest gradient, which a float32 case checks).  The attention pooling's
  score bias has the exact gradient 0 (a softmax does not see a shift), so
  it is held to 1e-12 of the model's largest gradient on both sides;
* three optimizer steps (warmup, clipping active, grad-accum 2) against the
  ``optax.chain`` of the root ``train.py``, to 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ltr_lowrank_sdp_tpu.data import loader as jax_loader
from ltr_lowrank_sdp_tpu.models import layers as jax_layers
from ltr_lowrank_sdp_tpu.models import loss as jax_loss
from ltr_lowrank_sdp_tpu.models import net as jax_net
from ltr_lowrank_sdp_torch import train
from ltr_lowrank_sdp_torch.data import loader
from ltr_lowrank_sdp_torch.models import checkpoint, loss, net
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.optim import (TrainOptimizer,
                                         warmup_cosine_decay_schedule)

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent
DATASET = str(ROOT / "dataset")
T = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's OpenMP workers spin after each parallel op and starve XLA's
    CPU threads in the same process; the sizes here need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------------- #


def _loss_case(case):
    rng = np.random.default_rng({"under": 0, "masks": 1, "padded": 2}[case])
    B = 6
    length = rng.integers(1, T + 1, B)
    if case == "padded":
        length[-2:] = 0             # rows that pad the graph axis
    mask = (np.arange(T)[None] < length[:, None]).astype(np.float64)
    target = np.where(mask > 0, rng.integers(1, 60, (B, T)), 0.0)
    pred = np.exp(rng.uniform(-2, 5, (B, T)))
    if case == "under":
        pred = np.minimum(pred, target + 0.5)   # mostly under-predicting
    if case == "masks":
        mask[1, 3] = 0.0            # a hole inside a schedule
    init = np.exp(rng.uniform(0, 4, (B, 1)))
    logits = rng.standard_normal((B, T))
    return pred, target, logits, length, mask, init


@pytest.mark.parametrize("with_init", [True, False])
@pytest.mark.parametrize("case", ["under", "masks", "padded"])
def test_loss_matches_jax(case, with_init):
    pred, target, logits, length, mask, init = _loss_case(case)
    w = dict(under_weight=3.67, mono_weight=0.1 if with_init else 0.0)
    want_total, want = jax_loss.rank_schedule_loss(
        *(jnp.asarray(a) for a in (pred, target, logits, length, mask)),
        jnp.asarray(init) if with_init else None,
        jax_loss.LossWeights(**w))
    got_total, got = loss.rank_schedule_loss(
        *(torch.tensor(a) for a in (pred, target, logits, length, mask)),
        torch.tensor(init) if with_init else None, loss.LossWeights(**w))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    if case == "padded":            # a padding row adds |log p - log 1e-6|
        assert float(got["final_loss"]) > 11.8 / 6


# --------------------------------------------------------------------------- #
# batching
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def datasets():
    ds_j, tr_j, va_j, te_j = jax_loader.create_splits(DATASET, seed=42)
    ds_t, tr_t, va_t, te_t = loader.create_splits(DATASET, seed=42)
    assert (tr_j, va_j, te_j) == (tr_t, va_t, te_t)
    sizes = {i: ds_j.get(i).x.shape[0] for i in range(len(ds_j))}
    return ds_j, ds_t, sorted(sizes, key=sizes.get)


def _same_batch(bt, bj):
    n, e = bt.x.shape[0], bt.edge_index.shape[1]
    assert bt.names == bj.names and bt.num_graphs == bj.num_graphs
    assert (bt.n_pad, bt.e_pad) == (bj.x.shape[0], bj.edge_index.shape[1])
    for name in ("global_attr", "schedule", "mask", "length"):
        np.testing.assert_array_equal(getattr(bt, name), getattr(bj, name))
    np.testing.assert_array_equal(bt.x, bj.x[:n])
    assert not bj.x[n:].any()
    np.testing.assert_array_equal(bt.edge_index, bj.edge_index[:, :e])
    np.testing.assert_array_equal(bt.edge_attr, bj.edge_attr[:e])
    np.testing.assert_array_equal(bt.batch, bj.batch[:n])
    assert (bj.batch[n:] == bj.num_graphs).all()     # dead nodes only


@pytest.mark.parametrize("shuffle", [False, True])
def test_iterate_batches_matches_jax(datasets, shuffle):
    """Budgets small enough that both the count and the size flushes fire,
    and one graph above the edge budget forms its own batch."""
    ds_j, ds_t, order = datasets
    idx = order[:14] + [order[30]]
    kw = dict(shuffle=shuffle, seed=7, edge_budget=60_000, node_budget=2_000)
    got = list(loader.iterate_batches(ds_t, idx, 5, **kw))
    want = list(jax_loader.iterate_batches(ds_j, idx, 5, **kw))
    assert len(got) == len(want) >= 4
    assert any(len(b.names) == 5 for b in got)
    assert any(len(b.names) == 1 for b in got)
    for bt, bj in zip(got, want):
        _same_batch(bt, bj)


@pytest.mark.parametrize("dropout", [0.0, 0.15])
def test_envelope_fill_matches_gatv2_on_padded_arrays(datasets, dropout):
    """The mean of the encoded edge features over the JAX envelope, from the
    real edges only (float64 on both sides: in float32 the two sums of
    65,536 rows part by 1e-5); with dropout, the dead rows' part, its mean
    and spread over many draws against the JAX encoder's on rows of
    zeros."""
    ds_j, ds_t, order = datasets
    bj = jax_loader.collate([ds_j.get(i) for i in order[:3]],
                            pad_graphs_to=8)
    bt = loader.collate([ds_t.get(i) for i in order[:3]], pad_graphs_to=8)
    assert bt.e_pad > bt.edge_index.shape[1]         # dead edges exist
    enc = jax_layers.EdgeEncoder(8, dropout)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(bj.edge_attr))
    params = jax.tree.map(lambda p: p + 0.1 if p.ndim == 1 else p, params)
    ours = net.GNNEncoder(net.ModelConfig(hidden_dim=16, edge_dim=8,
                                          global_dim=8, num_gnn_layers=1,
                                          num_heads=2, dropout=dropout))
    ours.edge_encoder.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    e = torch.tensor(bt.edge_attr)
    if dropout == 0.0:
        want = jnp.mean(enc.apply(
            jax.tree.map(lambda p: p.astype(jnp.float64), params),
            jnp.asarray(bj.edge_attr, jnp.float64)), 0)
        ours.double()
        with torch.no_grad():
            got = ours.edge_fill(ours.edge_encoder(e.double()), bt.envelope)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-12)
        return
    # the dead rows' part of the fill: k rows of zeros, each with its own
    # mask, against the port's binomial sum
    k = bt.e_pad - bt.edge_index.shape[1]
    zeros = jnp.zeros((k, bj.edge_attr.shape[1]), jnp.float32)
    draws = 200
    want = np.stack([np.asarray(jnp.sum(enc.apply(
        params, zeros, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(s)}), 0)) for s in range(draws)])
    ours.train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        got = np.stack([ours.edge_encoder.mlp.zero_rows_sum(k, gen).numpy()
                        for _ in range(draws)])
    # means agree within 5 standard errors, spreads within 25 %
    se = np.sqrt((want.var(0) + got.var(0)) / draws)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) <= 5 * se + 1e-6)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.25)


# --------------------------------------------------------------------------- #
# teacher-forced forward and gradients of a small predictor
# --------------------------------------------------------------------------- #

SMALL = dict(hidden_dim=16, edge_dim=8, global_dim=8, num_gnn_layers=2,
             num_heads=2, decoder_hidden_dim=16, decoder_num_layers=2,
             max_seq_len=T, dropout=0.0)
TF_RATIO = 0.5


@pytest.fixture(scope="module")
def small_case(datasets):
    """A collated batch of the three smallest dataset graphs (graph axis
    padded to 8), JAX parameters (biases moved off zero) and the JAX
    package's teacher-forcing coins for one step."""
    ds_j, ds_t, order = datasets
    bj = jax_loader.collate([ds_j.get(i) for i in order[:3]],
                            pad_graphs_to=8)
    bt = loader.collate([ds_t.get(i) for i in order[:3]], pad_graphs_to=8)
    cfg = jax_net.ModelConfig(**SMALL)
    model = jax_net.RankSchedulePredictor(cfg)
    args = [jnp.asarray(a) for a in (bj.x, bj.edge_index, bj.edge_attr,
                                     bj.batch, bj.global_attr)]
    params = model.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)}, *args,
                        bj.num_graphs)
    params = jax.tree.map(lambda p: p + 0.05 if p.ndim == 1 else p, params)
    tf_rng = jax.random.fold_in(jax.random.PRNGKey(5), 17)
    coins = np.asarray(jax.vmap(
        lambda t: jax.random.uniform(jax.random.fold_in(tf_rng, t)))(
        jnp.arange(T)))
    assert (coins < TF_RATIO).any() and (coins >= TF_RATIO).any()
    return model, params, bj, bt, args, tf_rng, coins


def _jax_loss(model, args, bj, tf_rng, dtype):
    lw = jax_loss.LossWeights(under_weight=3.67)

    def f(p):
        preds, ll, ir = model.apply(
            p, *args, bj.num_graphs,
            target_schedule=jnp.asarray(bj.schedule, dtype),
            target_mask=jnp.asarray(bj.mask, dtype),
            teacher_forcing_ratio=TF_RATIO, deterministic=False,
            tf_rng=tf_rng, rngs={"dropout": jax.random.PRNGKey(2)})
        total, _ = jax_loss.rank_schedule_loss(
            preds, jnp.asarray(bj.schedule, dtype), ll,
            jnp.asarray(bj.length), jnp.asarray(bj.mask, dtype), ir, lw)
        return total, (preds, ll, ir)

    return f


def _port_model(params, dtype):
    m = net.RankSchedulePredictor(net.ModelConfig(**SMALL))
    m.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    return m.to(dtype).train()


def _port_loss(m, bt, coins, dtype):
    t = train.batch_tensors(bt, "cpu")
    t = {k: v.to(dtype) if v.is_floating_point() else v for k, v in t.items()}
    K.reset_counts()
    total, comps = train.train_loss(
        m, t, bt, loss.LossWeights(under_weight=3.67), TF_RATIO,
        coins=torch.tensor(coins, dtype=dtype))
    return total, comps


def test_teacher_forced_forward_matches_jax(small_case):
    model, params, bj, bt, args, tf_rng, coins = small_case
    want_loss, (preds, ll, ir) = _jax_loss(model, args, bj, tf_rng,
                                           jnp.float32)(params)
    m = _port_model(params, torch.float32)
    with torch.no_grad():
        t = train.batch_tensors(bt, "cpu")
        got = m(t["x"], t["edge_index"], t["edge_attr"], t["batch"],
                t["global_attr"], bt.num_graphs, t["schedule"], t["mask"],
                TF_RATIO, coins=torch.tensor(coins), envelope=bt.envelope)
        got_loss, _ = _port_loss(m, bt, coins, torch.float32)
    for a, b in zip(got, (preds, ll, ir)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gradients_match_jax_value_and_grad(small_case, dtype):
    model, params, bj, bt, args, tf_rng, coins = small_case
    jdt, tdt = {"float64": (jnp.float64, torch.float64),
                "float32": (jnp.float32, torch.float32)}[dtype]
    params = jax.tree.map(lambda p: p.astype(jdt), params)
    args = [a.astype(jdt) if jnp.issubdtype(a.dtype, jnp.floating) else a
            for a in args]
    (want_loss, _), grads = jax.value_and_grad(
        _jax_loss(model, args, bj, tf_rng, jdt), has_aux=True)(params)
    m = _port_model(params, tdt)
    got_loss, _ = _port_loss(m, bt, coins, tdt)
    got_loss.backward()
    counts = K.counts()
    assert counts["gatv2_softmax_agg_bwd"] == (0, 2)   # one per layer
    assert counts["graph_pool_bwd"] == (0, 1)
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=1e-9 if dtype == "float64" else 1e-5)
    want = checkpoint.params_from_flax(
        jax.tree.map(lambda g: np.asarray(g, np.float64), grads))
    got = {k: p.grad.double() for k, p in m.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        if k == "encoder.attn_pool.dense_1.bias":       # exactly 0
            zero_tol = (1e-12 if dtype == "float64" else 1e-5) * largest
            assert float(w.abs().max()) <= zero_tol
            assert float(got[k].abs().max()) <= zero_tol, k
        elif dtype == "float64":
            assert err <= 1e-4 * float(w.abs().max()), (k, err)
        else:
            assert err <= 1e-4 * largest, (k, err)


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_optimizer_matches_optax_chain(grad_accum):
    """Three updates of the root train.py's optax chain: the first at the
    warmup's learning rate 0, a gradient above the clip norm, and (with
    grad-accum 2) six mini-batches averaged in pairs."""
    rng = np.random.default_rng(grad_accum)
    shapes = {"w": (5, 3), "b": (3,), "s": (4,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    steps = 3 * grad_accum
    grads = [{k: (rng.standard_normal(s) * (3.0 if i == 2 else 0.1)).astype(
        np.float32) for k, s in shapes.items()} for i in range(steps)]
    lr, wd, clip = 3e-2, 1e-2, 1.0
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 2, 10,
                                               end_value=lr * 1e-2)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd))
    if grad_accum > 1:
        tx = optax.MultiSteps(tx, grad_accum)
    params = jax.tree.map(jnp.asarray, p0)
    state = tx.init(params)
    ours = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = TrainOptimizer(ours.values(), warmup_cosine_decay_schedule(
        0.0, lr, 2, 10, end_value=lr * 1e-2), wd, clip, grad_accum)
    for i, g in enumerate(grads):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        for k, p in ours.items():
            p.grad = torch.tensor(g[k])
        assert opt.step() == ((i + 1) % grad_accum == 0)
        for k, p in ours.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {i}")
    assert opt.count == 3
    np.testing.assert_allclose(
        [warmup_cosine_decay_schedule(0.0, lr, 2, 10, lr * 1e-2)(c)
         for c in range(12)], [float(sched(c)) for c in range(12)],
        rtol=1e-6)


def test_schedule_without_warmup_and_teacher_forcing_decay():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 0, 5, 1e-5)
    ours = warmup_cosine_decay_schedule(0.0, 1e-3, 0, 5, 1e-5)
    np.testing.assert_allclose([ours(c) for c in range(7)],
                               [float(sched(c)) for c in range(7)],
                               rtol=1e-6)
    import train as root_train

    for e, n in ((0, 1), (0, 5), (3, 5), (4, 5), (9, 5)):
        assert train.get_teacher_forcing_ratio(e, n, 0.9, 0.2) == \
            root_train.get_teacher_forcing_ratio(e, n, 0.9, 0.2)

