"""The port's two float32 faults held against the JAX package's own float32
behaviour, on the CPU.

HALLaR's float32 min-eig inner solve (the case of
``test_torch_hallar_solve.py``): its stop test ``L ||Y_n - Z|| <= 1e-8 (1 +
||Y_n||)`` asks for less than float32's epsilon, so it fires only when Y_n
equals Z to the bit.  The JAX package gets there because its compiled
backtracking test fails on rounding (115 of its 155 failed tests on the file
order pass in exact arithmetic), so its L climbs until the step drops below
Z's last bit; over 64 permuted orders of C's entries (the same matrix,
another order of every sum) it stops after 38 to 1,265 steps.  The port's
test passes at the noise floor and its solve ran to the cap of 10,000 on
some orders, so the port floors the stop tolerance at ``STOP_TOL_EPS`` = 4
epsilons of the dtype (``hallar/solver.py``; float64 unchanged): over the
same orders it then stops after at most 827 steps.  The test holds every
port solve to stop before its cap and no later than the JAX package's
latest over the same orders, with the objectives of each order within 1e-6.

The float32 training step at 4 heads x 128 channels: each gradient leaf's
error against the float64 step, as ``chip_smoke.py``'s GRAD_TOL measures it
(max |g - g64| over the leaf's largest |g64|), for the JAX package's own
float32 step and for the port's CPU float32 step, with 2 GNN layers.  On the
two smallest graphs of the seeded test split the JAX package misses 1e-4 as
the port does, at the same leaf, and the first test holds the port within 2x
of it.  On other batches both steps cross a jump of the reference's own
function: the max pooling picks another node in float32 than in float64 in
some channels.  So the second test fixes that node in every step to the
JAX float64 step's choice (the pooling becomes a gather there, a tie split
equally; the JAX package through a stand-in for its ``net`` module's
``jax`` name, the port through a wrapper of ``graph_pool``), which leaves
rounding alone to compare.  That showed where the port departed: its
backwards of the two segment softmaxes (GATv2's, K11, and the attention
pooling's, K12) dropped the gradient that the JAX package's VJP routes
through the softmax's max stabiliser (``score - segment_max(score)``):
the segment's sum of the score gradients, 0 in exact arithmetic, which
there cancels the rounding left in them; the leaves behind the softmaxes
(``convs.*.att``, ``attn_pool``, the edge encoder) were 5-11x JAX's.  The
port's plain versions and kernels now add it (``kernels._max_path``), and
the test holds that repair against the previous plain formulas (kept here
as ``_unrepaired_*``).  On the three graphs together the port's worst leaf
stayed 25x JAX's at ``convs.0.lin_dst.weight``.  Swapping each input of
GAT layer 0's backward for the JAX step's value (``evidence("inputs")``)
showed a second jump of the function there, not a departure of the port: a
message within float32 rounding of 0 takes the other LeakyReLU branch in
float32 than in float64 (0.8 att ds at that slot); the JAX step crosses
such kinks too.  With every message's branch fixed to the float64 step's as
well (``evidence("branches")``; the JAX package through a stand-in for its
``gatv2`` module's ``nn`` name, the port through its plain backward's
``branch``), the port's worst leaf lies below JAX's on all four batches.
``test_leaky_relu_kink_is_a_jump_of_the_function`` pins the mechanism on a
planted message.

``PYTHONPATH=. python tests/test_torch_f32_faults.py [part ...]`` prints the
evidence behind the numbers above (``evidence``'s parts: the 64 JAX orders
and the port's over the same orders; the 4 x 128 step on four batches of the
three graphs, with and without the node fixed, and with the LeakyReLU
branches fixed too; K11's inputs swapped one by one; the wide widths of
``chip_smoke.py``; the port's float32 step stage by stage); a batch with the
23,028-node graph takes about 52 GB without the node fixed and 27 GB with it.
``F32_FAULT_THREADS`` sets the torch threads (default 1).
"""

import dataclasses
import gc
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ltr_lowrank_sdp_torch.data import loader
from ltr_lowrank_sdp_torch.hallar import solver as TS
from ltr_lowrank_sdp_torch.models import checkpoint, net
from ltr_lowrank_sdp_tpu.data import loader as jax_loader
from ltr_lowrank_sdp_tpu.hallar import solver as JS
from ltr_lowrank_sdp_tpu.models import net as jax_net

import test_torch_hallar_solve as hallar_case
import test_torch_train as train_case

GRAD_TOL = 1e-4          # chip_smoke.py's per-leaf gradient bound
MIN_EIG = dict(eps_gap=1e-4, maxiter_hallar=200, lanczos_iters=24,
               dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# HALLaR's float32 stop step
# --------------------------------------------------------------------------- #


def _permuted(mod, seed):
    """The min-eig case with its C entries in a seeded order (None: the
    file's own)."""
    prob, lam = hallar_case.min_eig_problem(mod)
    if seed is None:
        return prob, lam
    order = np.random.default_rng(seed).permutation(prob.c_rows.size)
    return dataclasses.replace(prob, c_rows=prob.c_rows[order],
                               c_cols=prob.c_cols[order],
                               c_vals=prob.c_vals[order]), lam


def _nudged_y0():
    """The reference's default Y0 times (1 + 2^-23)."""
    r = JS.HallarParams().init_rank
    y0 = np.random.default_rng(0).normal(size=(12, r))
    return y0 / np.linalg.norm(y0) * (1.0 + 2.0 ** -23)


def jax_stop_steps(monkeypatch, cases):
    """(FISTA steps of each inner solve, result) of the JAX package's
    float32 solve for each (order seed, Y0) of ``cases``."""
    steps = hallar_case.counting_jax_steps(monkeypatch)
    out = []
    for seed, y0 in cases:
        steps.clear()
        res = JS.hallar_solve(_permuted(JS, seed)[0],
                              JS.HallarParams(**MIN_EIG), Y0=y0)
        out.append((list(steps), res))
    return out


def port_solve(seed, y0=None):
    return TS.hallar_solve(_permuted(TS, seed)[0], TS.HallarParams(**MIN_EIG),
                           device="cpu", Y0=y0,
                           lanczos_start=hallar_case.jax_start("float32"))


CASES = [(None, None)] + [(s, None) for s in range(8)] + [(None, "nudged")]


def test_float32_stop_step_lies_within_the_jax_spread(monkeypatch):
    """The JAX float32 solve and the port's over the file order, eight
    permuted orders of C's entries and the nudged Y0: every solve converges
    in one outer iteration, every port solve stops before its cap, the
    port's largest stop step is no larger than JAX's largest, and on each
    order the objectives agree to 1e-6 relative."""
    cases = [(seed, _nudged_y0() if y0 else None) for seed, y0 in CASES]
    runs = jax_stop_steps(monkeypatch, cases)
    jax_steps = [s[0] for s, _ in runs]
    assert all(len(s) == 1 and r.iters == 1 and r.converged
               for s, r in runs)
    got = [port_solve(seed, y0) for seed, y0 in cases]
    port_steps = [g.fista_steps for g in got]
    print("float32 stop steps (file order, 8 orders, nudged Y0): JAX",
          jax_steps, "port", port_steps)
    assert all(g.iters == 1 and g.converged for g in got)
    assert max(port_steps) < TS.HallarParams().maxiter_fista
    assert max(port_steps) <= max(jax_steps)
    for g, (_, r) in zip(got, runs):
        assert abs(g.pobj - r.pobj) <= 1e-6 * abs(r.pobj)


# --------------------------------------------------------------------------- #
# the float32 training step at 4 heads x 128 channels
# --------------------------------------------------------------------------- #

WIDE = dict(node_in_dim=16, edge_in_dim=5, global_in_dim=17, hidden_dim=512,
            edge_dim=32, global_dim=32, num_gnn_layers=2, num_heads=4,
            decoder_hidden_dim=96, decoder_num_layers=2, max_seq_len=16,
            dropout=0.0)
def _leaf_errors(got, want):
    """chip_smoke.py's measure: each leaf's max |g - g64| over the leaf's
    largest |g64| (over the model's largest gradient for a leaf that is 0
    up to rounding)."""
    largest = max(float(w.abs().max()) for w in want.values())
    out = {}
    for k, w in want.items():
        own = float(w.abs().max())
        scale = own if own > 1e-12 * largest else largest
        out[k] = float((got[k] - w).abs().max()) / scale
    return out


def wide_batch(pick=(0, 1)):
    """The graphs of the seeded test split at the places ``pick`` of its
    order by size (0 the smallest) collated by both packages, the 512-wide
    model's JAX parameters (biases moved off 0) and the teacher-forcing
    coins."""
    ds_j, _, _, te_j = jax_loader.create_splits(train_case.DATASET, seed=42)
    ds_t, _, _, te_t = loader.create_splits(train_case.DATASET, seed=42)
    assert te_j == te_t
    sizes = {i: ds_j.get(i).x.shape[0] for i in te_j}
    order = sorted(te_j, key=sizes.get)
    graphs = [order[k] for k in pick]
    bj = jax_loader.collate([ds_j.get(i) for i in graphs],
                            pad_graphs_to=len(graphs))
    bt = loader.collate([ds_t.get(i) for i in graphs],
                        pad_graphs_to=len(graphs))
    model = jax_net.RankSchedulePredictor(jax_net.ModelConfig(**WIDE))
    args = [jnp.asarray(a) for a in (bj.x, bj.edge_index, bj.edge_attr,
                                     bj.batch, bj.global_attr)]
    params = model.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(1)}, *args,
                        bj.num_graphs)
    params = jax.tree.map(lambda p: p + 0.05 if p.ndim == 1 else p, params)
    tf_rng = jax.random.fold_in(jax.random.PRNGKey(5), 17)
    coins = np.asarray(jax.vmap(
        lambda t: jax.random.uniform(jax.random.fold_in(tf_rng, t)))(
        jnp.arange(WIDE["max_seq_len"])))
    return model, params, bj, bt, args, tf_rng, coins


@pytest.fixture(scope="module")
def wide_case():
    """The two smallest graphs of the seeded test split (``wide_batch``)."""
    return wide_batch()


def _jax_grads(case, jdt):
    model, params, bj, _, args, tf_rng, _ = case
    p = jax.tree.map(lambda q: q.astype(jdt), params)
    a = [x.astype(jdt) if jnp.issubdtype(x.dtype, jnp.floating) else x
         for x in args]
    _, g = jax.jit(jax.value_and_grad(
        train_case._jax_loss(model, a, bj, tf_rng, jdt), has_aux=True))(p)
    return checkpoint.params_from_flax(
        jax.tree.map(lambda q: np.asarray(q, np.float64), g))


def _port_grads(case, tdt):
    _, params, _, bt, _, _, coins = case
    m = net.RankSchedulePredictor(net.ModelConfig(**WIDE))
    m.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    m = m.to(tdt).train()
    total, _ = train_case._port_loss(m, bt, coins, tdt)
    total.backward()
    return {k: p.grad.double() for k, p in m.named_parameters()}


def _module(leaf):
    return leaf.rsplit(".", 1)[0]


def test_float32_step_at_4x128_against_the_jax_float32_step(wide_case):
    """On the two smallest test graphs, against the JAX package's float64
    gradient: its own float32 step misses GRAD_TOL, the port's float32
    worst leaf is at most twice JAX's, and the two worst leaves sit in the
    same module.  (On the three smallest the port's is 2.9x JAX's, in
    another module, from two jumps of the function that float32 and
    float64 take apart, the max pooling's node and LeakyReLU branches,
    ``ROADMAP.md`` Queue 3; that batch takes 320 s and 52 GB on one thread,
    beyond a tier-1 test, and :func:`evidence` measures it.)"""
    g64 = _jax_grads(wide_case, jnp.float64)
    jax32 = _leaf_errors(_jax_grads(wide_case, jnp.float32), g64)
    port32 = _leaf_errors(_port_grads(wide_case, torch.float32), g64)
    port64 = _leaf_errors(_port_grads(wide_case, torch.float64), g64)
    jw = max(jax32.items(), key=lambda kv: kv[1])
    pw = max(port32.items(), key=lambda kv: kv[1])
    print("JAX float32 worst leaf", jw, "port float32", pw,
          "port float64", max(port64.values()))
    assert max(port64.values()) <= 1e-6       # the same function
    assert jw[1] > GRAD_TOL
    assert pw[1] <= 2.0 * jw[1]
    assert _module(pw[0]) == _module(jw[0])


# --------------------------------------------------------------------------- #
# the same step with the max pooling's node fixed to the float64 one
# --------------------------------------------------------------------------- #


class _NetJax:
    """Stands for the ``jax`` name of ``ltr_lowrank_sdp_tpu.models.net``:
    every attribute is jax's own, but ``ops.segment_max`` is ``seg_max``.
    Only the graph pooling of ``GNNEncoder`` calls ``jax.ops.segment_max``
    through that name; ``gatv2.py`` and ``layers.py`` keep their own."""

    def __init__(self, seg_max):
        self.ops = types.SimpleNamespace(segment_sum=jax.ops.segment_sum,
                                         segment_max=seg_max)

    def __getattr__(self, name):
        return getattr(jax, name)


class _GatNn:
    """Stands for the ``nn`` name (flax.linen) of
    ``ltr_lowrank_sdp_tpu.models.gatv2``: every attribute is flax's own,
    but ``leaky_relu`` takes each message's branch from
    ``held["masks"][held["layer"]]`` (True: the identity, False: the slope),
    the layer whose ``__call__`` runs (set by :func:`_layer_tracker`)."""

    def __init__(self, held):
        self.held = held

    def leaky_relu(self, x, negative_slope=0.01):
        import flax.linen as nn
        layer = self.held.get("layer")
        if self.held.get("masks") is None or layer is None:
            return nn.leaky_relu(x, negative_slope=negative_slope)
        return jnp.where(self.held["masks"][layer], x, negative_slope * x)

    def __getattr__(self, name):
        import flax.linen as nn
        return getattr(nn, name)


def _layer_tracker(held):
    """A ``flax.linen.intercept_methods`` interceptor that holds the index
    of the GATv2 layer whose ``__call__`` runs in ``held["layer"]``."""
    def intercept(next_fun, args, kwargs, context):
        path = tuple(p.replace("Checkpoint", "") for p in context.module.path)
        if (context.method_name == "__call__" and len(path) == 2
                and path[0] == "encoder" and path[1].startswith("GATv2Conv_")):
            held["layer"] = int(path[1].rsplit("_", 1)[1])
            try:
                return next_fun(*args, **kwargs)
            finally:
                held["layer"] = None
        return next_fun(*args, **kwargs)

    return intercept


def _jax_step(case, jdt, seg_max, w=None, masks=None):
    """``_jax_grads`` with the ``jax`` name of the JAX package's ``net``
    module bound to ``_NetJax(seg_max)``; ``seg_max`` reads the weights
    ``w`` (if any) from ``held["w"]``.  With ``masks`` (one (E, H, C) bool
    array a GATv2 layer, in JAX's layout), every LeakyReLU of a GATv2
    message takes the branch the mask gives (``_GatNn``).  The inputs,
    ``w`` and the masks enter the jitted step as arguments: closed over,
    XLA folds gathers of them into constants, which takes tens of GB on the
    23,028-node graph."""
    import flax.linen as nn
    from ltr_lowrank_sdp_tpu.models import gatv2 as jax_gatv2
    model, params, bj, _, args, tf_rng, _ = case
    held = {}

    def loss(p, a, wt, mk):
        held["w"], held["masks"] = wt, mk
        return train_case._jax_loss(model, a, bj, tf_rng, jdt)(p)

    p = jax.tree.map(lambda q: q.astype(jdt), params)
    a = [x.astype(jdt) if jnp.issubdtype(x.dtype, jnp.floating) else x
         for x in args]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_net, "jax", _NetJax(lambda x, ids, num:
                                       seg_max(x, ids, num, held["w"])))
    if masks is not None:
        mp.setattr(jax_gatv2, "nn", _GatNn(held))
    try:
        with nn.intercept_methods(_layer_tracker(held)):
            _, g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                p, a, None if w is None else jnp.asarray(w, jdt),
                None if masks is None else [jnp.asarray(m) for m in masks])
    finally:
        mp.undo()
    return checkpoint.params_from_flax(
        jax.tree.map(lambda q: np.asarray(q, np.float64), g))


def float64_max_nodes(case):
    """(n_pad, d) weights of the JAX package's float64 step's max pooling:
    per graph and channel 1 / k at the k nodes where the pooling input
    equals the float64 maximum, else 0 (a tie is split equally, as
    ``jax.ops.segment_max``'s gradient and the port's K12 split it)."""
    seen = {}

    def capture(x, ids, num, _):
        jax.debug.callback(lambda v: seen.__setitem__("x", np.asarray(v)), x)
        return jax.ops.segment_max(x, ids, num)

    _jax_step(case, jnp.float64, capture)
    x, batch = seen["x"], np.asarray(case[2].batch)
    w = np.zeros_like(x)
    for b in range(case[2].num_graphs):
        rows = batch == b
        if rows.any():
            hit = x[rows] == x[rows].max(axis=0)
            w[rows] = hit / hit.sum(axis=0)
    return w


def _gather(x, ids, num, w):
    return jax.ops.segment_sum(x * w, ids, num)


def _fixed_jax_grads(case, jdt, w, masks=None):
    return _jax_step(case, jdt, _gather, w, masks)


def _fixed_port_grads(case, tdt, w):
    """The port's step with the ``max x`` third of K10's ``[mean | max |
    attention]`` output replaced by the same fixed gather."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    bt = case[3]
    pool = K.graph_pool

    def fixed(seg, x, score, keep=None):
        out = pool(seg, x, score, keep)
        n, d = x.shape
        ids = torch.as_tensor(np.asarray(bt.batch)[:n]).long()
        mx = torch.zeros((bt.num_graphs, d), dtype=x.dtype).index_add_(
            0, ids, x * torch.as_tensor(w[:n], dtype=x.dtype))
        return torch.cat([out[:, :d], mx, out[:, 2 * d:]], dim=1)

    K.graph_pool = fixed
    try:
        return _port_grads(case, tdt)
    finally:
        K.graph_pool = pool


def fixed_node_errors(case):
    """Each leaf's error (``_leaf_errors``) of the JAX package's float32
    step, of the port's float32 step and of the port's float64 step, all
    with the max pooling's node fixed to the JAX float64 step's, against
    the JAX float64 step with the same node fixed."""
    w = float64_max_nodes(case)
    g64 = _fixed_jax_grads(case, jnp.float64, w)
    return {"JAX float32": _leaf_errors(_fixed_jax_grads(case, jnp.float32,
                                                         w), g64),
            "port float32": _leaf_errors(_fixed_port_grads(
                case, torch.float32, w), g64),
            "port float64": _leaf_errors(_fixed_port_grads(
                case, torch.float64, w), g64)}


def _worst(errs):
    return max(errs.items(), key=lambda kv: kv[1])


LEAF_FLOOR = GRAD_TOL / 10    # a leaf error below this is not compared


def leaf_ratio(port, jax_errs):
    """(largest ratio, leaf) of the port's error at a leaf over the JAX
    package's at the same leaf, the latter floored at LEAF_FLOOR."""
    return max((port[k] / max(jax_errs[k], LEAF_FLOOR), k) for k in port)


def _unrepaired_pool_bwd(seg, x, score, keep, out, stats, ties, dout):
    """K12's plain backward before the repair: no stabiliser term."""
    d = x.shape[1]
    batch = seg.batch_ids
    counts = (seg.ptr[1:] - seg.ptr[:-1]).to(x.dtype)
    dmean = dout[:, :d] / torch.clamp(counts, min=1.0)[:, None]
    dmax = dout[:, d:2 * d] / torch.clamp(ties, min=1.0)
    dattn = dout[:, 2 * d:]
    w = torch.exp(score - stats[batch, 0]) / (stats[batch, 1] + 1e-16)
    kw = w if keep is None else keep * w
    a = torch.sum(x * dattn[batch], dim=1)
    dot = torch.sum(dattn * out[:, 2 * d:], dim=1)
    dx = (dmean[batch]
          + torch.where(x == out[batch, d:2 * d], dmax[batch], 0.0)
          + kw[:, None] * dattn[batch])
    return dx, w * ((a if keep is None else keep * a) - dot[batch])


def _unrepaired_gat_bwd(g, w_src, w_dst, we, we_loop, att, keep, lse, out,
                        dout, scores=None):
    """K11's plain backward before the repair: no stabiliser term."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    heads, ch = att.shape
    hc = heads * ch
    dst = g.dst_ids
    xs, msg, s = K._gatv2_messages(g, w_src, w_dst, we, we_loop, att)
    scores = s if scores is None else scores.to(s.dtype)
    alpha = torch.exp(scores - lse[dst])
    kp = torch.ones_like(alpha) if keep is None else keep
    go = dout.view(-1, heads, ch)
    dalpha = kp * torch.sum(go[dst] * xs, dim=-1)
    dd = torch.sum(go * out.view(-1, heads, ch), dim=-1)
    ds = alpha * (dalpha - dd[dst])
    act = torch.where(msg >= 0, msg, K.LEAKY_SLOPE * msg)
    dmsg = (ds[..., None] * att * torch.where(msg >= 0, 1.0, K.LEAKY_SLOPE)
            ).reshape(-1, hc)
    d_att = torch.sum(ds[..., None] * act, dim=0)
    zeros = torch.zeros((g.n, hc), dtype=w_src.dtype, device=w_src.device)
    d_w_dst = zeros.clone().index_add_(0, dst, dmsg)
    d_w_src = zeros.index_add_(
        0, g.src.long(),
        ((alpha * kp)[..., None] * go[dst]).reshape(-1, hc) + dmsg)
    erow = g.erow.long()
    real = erow < g.n_real
    d_we = torch.zeros_like(we).index_add_(0, erow[real], dmsg[real])
    return d_w_src, d_w_dst, d_we, torch.sum(dmsg[~real], dim=0), d_att


def before_the_repair_grads(case, tdt, w):
    """``_fixed_port_grads`` with the two plain backwards as they were
    before the repair."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    mp = pytest.MonkeyPatch()
    mp.setattr(K, "graph_pool_bwd_plain", _unrepaired_pool_bwd)
    mp.setattr(K, "gatv2_softmax_agg_bwd_plain", _unrepaired_gat_bwd)
    try:
        return _fixed_port_grads(case, tdt, w)
    finally:
        mp.undo()


def port_float64_reference(case):
    """(weights, gradients) of the port's float64 step with the max
    pooling's node fixed to its own float64 choice: ``float64_max_nodes``
    on the port's float64 forward, then ``_fixed_port_grads``.  It stands
    in for the JAX float64 step, which it equals to 1e-6 at every leaf (the
    tier-1 test), where that does not fit the host: on a batch with the
    23,028-node graph the JAX float64 step passes 44 GB, the port's takes
    27 GB."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    seen = {}
    pool = K.graph_pool

    def capture(seg, x, score, keep=None):
        seen["x"] = x.detach().numpy().copy()
        return pool(seg, x, score, keep)

    K.graph_pool = capture
    try:
        _port_grads(case, torch.float64)
    finally:
        K.graph_pool = pool
    x, bj, bt = seen["x"], case[2], case[3]
    batch = np.asarray(bt.batch)[:x.shape[0]]
    w = np.zeros((bj.x.shape[0], x.shape[1]))
    for b in range(bt.num_graphs):
        rows = np.flatnonzero(batch == b)
        if rows.size:
            hit = x[rows] == x[rows].max(axis=0)
            w[rows] = hit / hit.sum(axis=0)
    gc.collect()
    return w, _fixed_port_grads(case, torch.float64, w)


def fixed_node_evidence(pick):
    """The 4 x 128 step on the test graphs ``pick`` with the max pooling's
    node fixed: the worst leaves of the JAX package's float32 step, of the
    port's and of the port's before the repair, and the largest port / JAX
    ratio at one leaf (``leaf_ratio``), against the JAX float64 step (the
    port's, ``port_float64_reference``, on a batch with graph 2)."""
    case = wide_batch(pick)
    if 2 in pick:
        ref, (w, g64) = "port", port_float64_reference(case)
    else:
        w = float64_max_nodes(case)
        ref, g64 = "JAX", _fixed_jax_grads(case, jnp.float64, w)
    jax.clear_caches()
    errs = {"JAX": _leaf_errors(_fixed_jax_grads(case, jnp.float32, w), g64)}
    jax.clear_caches()
    gc.collect()
    errs["port"] = _leaf_errors(_fixed_port_grads(case, torch.float32, w),
                                g64)
    gc.collect()
    errs["port before the repair"] = _leaf_errors(
        before_the_repair_grads(case, torch.float32, w), g64)
    for name, e in errs.items():
        worst = _worst(e)
        ratio = ("" if name == "JAX" else
                 ", largest port / JAX at one leaf %.2f (%s)"
                 % leaf_ratio(e, errs["JAX"]))
        print(f"4 x 128, test graphs {pick} by size, max node fixed "
              f"({ref} float64 reference): {name} float32 worst leaf "
              f"{worst[0]} {worst[1]:.3e}{ratio}", flush=True)


def test_float32_step_with_the_max_node_fixed(wide_case):
    """The two smallest test graphs with the max pooling's node fixed to
    the JAX package's float64 choice in every step, against the JAX float64
    step so fixed: the port's float64 step is the same function (1e-6), its
    float32 worst leaf is within 2x of JAX's float32 worst leaf, and at no
    leaf is the port's error more than 4x JAX's at that leaf (leaf errors
    floored at LEAF_FLOOR).  Before the repair of the two segment-softmax
    backwards (``kernels._max_path``) that last
    ratio exceeded 4 (``convs.0.att``, about 11x): the port dropped the
    gradient that the JAX package's VJP routes through the softmax's max
    stabiliser, which cancels the rounding left in the score gradients."""
    w = float64_max_nodes(wide_case)
    g64 = _fixed_jax_grads(wide_case, jnp.float64, w)
    jax32 = _leaf_errors(_fixed_jax_grads(wide_case, jnp.float32, w), g64)
    port32 = _leaf_errors(_fixed_port_grads(wide_case, torch.float32, w),
                          g64)
    port64 = _leaf_errors(_fixed_port_grads(wide_case, torch.float64, w),
                          g64)
    before = _leaf_errors(before_the_repair_grads(wide_case, torch.float32,
                                                  w), g64)
    ratio, before_ratio = leaf_ratio(port32, jax32), leaf_ratio(before, jax32)
    print("fixed node: JAX float32 worst leaf", _worst(jax32), "port",
          _worst(port32), "port / JAX by leaf", ratio, "before the repair",
          before_ratio)
    assert max(port64.values()) <= 1e-6
    assert _worst(port32)[1] <= 2.0 * _worst(jax32)[1]
    assert ratio[0] <= 4.0 < before_ratio[0]


def _planted_kink(seed=0):
    """A GATv2 layer (60 nodes, 400 edges, 2 heads x 8 channels) in float64
    with one real edge's message at one channel planted at the LeakyReLU's
    kink: its float32 inputs (the float64 ones rounded) sum to -2^-24 in
    float32 (the slope's branch), the float64 inputs, one float32 ulp of
    w_dst apart, to +2^-24 (the identity's); -> (float64 arguments of K11,
    float32 arguments, the planted slot, head, channel)."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    rng = np.random.default_rng(seed)
    n, e, heads, ch = 60, 400, 2, 8
    ei = rng.integers(0, n, size=(2, e))
    g = K.EdgeCSR.from_edge_index(torch.tensor(ei), n)
    hc = heads * ch
    w_src, w_dst = rng.normal(size=(n, hc)), rng.normal(size=(n, hc))
    we, we_loop = rng.normal(size=(e, hc)), rng.normal(size=hc)
    att = 2.0 * rng.normal(size=(heads, ch))
    slot = int(np.flatnonzero(g.erow.numpy() < e)[5])
    j, i, r = int(g.src[slot]), int(g.dst_ids[slot]), int(g.erow[slot])
    h, c = 1, 3
    col = h * ch + c
    w_src[j, col], we[r, col] = 0.5, 0.25
    w_dst[i, col] = -0.75 - 2.0 ** -24       # exact in float32
    args32 = [torch.tensor(a, dtype=torch.float32)
              for a in (w_src, w_dst, we, we_loop, att)]
    w_dst64 = w_dst.copy()
    w_dst64[i, col] += 2.0 ** -23
    args64 = [torch.tensor(a) for a in (w_src, w_dst64, we, we_loop, att)]
    return g, args64, args32, slot, h, c


def test_leaky_relu_kink_is_a_jump_of_the_function():
    """The 4 x 128 departure on the test split's three graphs (``python
    tests/test_torch_f32_faults.py inputs`` and ``branches``): a message
    within float32 rounding of 0 takes the slope's branch of the LeakyReLU
    in float32 and the identity's in float64, so K11's d_w_dst at its
    destination jumps by 0.8 ds att there, as the max pooling's node jumps:
    no float32 program avoids it, and with the float64 step's branch the
    port's float32 backward agrees with the float64 one to rounding.  Also
    the copy of the plain backward that the evidence swaps inputs in
    (``_k11_with``) gives the plain backward's bits."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    g, args64, args32, slot, h, c = _planted_kink()
    msg32 = K._gatv2_messages(g, *args32)[1]
    msg64 = K._gatv2_messages(g, *args64)[1]
    assert float(msg32[slot, h, c]) == -2.0 ** -24
    assert float(msg64[slot, h, c]) == 2.0 ** -24
    flips = (msg32 >= 0) != (msg64 >= 0)
    assert int(flips.sum()) == 1
    out64, lse64 = K._gatv2_plain(g, *args64)
    out32, lse32 = K._gatv2_plain(g, *args32)
    gen = np.random.default_rng(1)
    dout = gen.normal(size=tuple(out64.shape))
    want = K.gatv2_softmax_agg_bwd_plain(g, *args64, None, lse64, out64,
                                         torch.tensor(dout))
    f32 = (g, *args32, None, lse32, out32,
           torch.tensor(dout, dtype=torch.float32))
    own = K.gatv2_softmax_agg_bwd_plain(*f32)
    assert all(torch.equal(a, b) for a, b in zip(_k11_with(*f32), own))
    fixed = K.gatv2_softmax_agg_bwd_plain(*f32, branch=msg64 >= 0)

    def err(got):
        return float((got[1].double() - want[1]).abs().max()
                     / want[1].abs().max())

    # d_w_dst: the jump against float32 rounding
    print("d_w_dst error, float32 branch / float64 branch:", err(own),
          err(fixed))
    assert err(fixed) <= 1e-5
    assert err(own) >= 100.0 * err(fixed)


def failed_tests():
    """JAX's float32 inner loop on the file order, stepped one FISTA step a
    call (the body of ``_make_fista``, jitted; it stops at the same step
    with the same L): its failed backtracking tests, how many of them pass
    in exact arithmetic (float64 on the same float32 iterates and trial
    points) and how many the port's evaluation fails on the same inputs."""
    prob, _ = _permuted(JS, None)
    jops, jp = JS._Ops(prob, jnp.float32), JS.HallarParams(**MIN_EIG)
    tops = TS._Ops(_permuted(TS, None)[0], torch.float32, "cpu")
    p0 = torch.zeros(1)
    val, val_grad = TS.al_functions(tops, p0, 10.0)
    C = np.zeros((prob.n, prob.n))
    C[prob.c_rows, prob.c_cols] = prob.c_vals
    C = C + np.triu(C, 1).T

    def al(Y):
        resid = jops.AX(Y) - jops.b
        return (jops.CX(Y) + 5.0 * jnp.vdot(resid, resid),
                2.0 * jops.SY(10.0 * resid, Y))

    @jax.jit
    def step(Y, Z, tk, L):
        fz, gz = al(Z)

        def bt_cond(c):
            Yn = jops.project(Z - gz / c[0])
            diff = Yn - Z
            return ((al(Yn)[0] > fz + jnp.vdot(gz, diff)
                     + 0.5 * c[0] * jnp.vdot(diff, diff) + 1e-12)
                    & (c[0] < 1e12))

        L, n_bt = jax.lax.while_loop(
            bt_cond, lambda c: (c[0] * jp.L_inc_fista, c[1] + 1), (L, 0))
        Yn = jops.project(Z - gz / L)
        tn = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk * tk))
        done = L * jnp.linalg.norm(Yn - Z) <= jp.err_tol_fista * (
            1.0 + jnp.linalg.norm(Yn))
        return (Yn, Yn + ((tk - 1.0) / tn) * (Yn - Y), tn,
                jnp.maximum(L / jp.L_inc_fista, jp.L0_fista), done, n_bt, L)

    y0 = np.random.default_rng(0).normal(size=(prob.n, 2))
    Y = Z = jnp.asarray(y0 / np.linalg.norm(y0), jnp.float32)
    tk, L = jnp.float32(1.0), jnp.float32(1.0)
    fails = exact_pass = port_fails = steps = 0
    done = False
    while not done:
        Zt = torch.tensor(np.asarray(Z))
        fz, gz = val_grad(Zt)
        Lt = float(L)
        Y, Z, tk, L, done, n_bt, L_used = step(Y, Z, tk, L)
        steps += 1
        for _ in range(int(n_bt)):
            Yc = tops.project(Zt - gz / Lt)
            d = (Yc - Zt).double().numpy()
            z64, y64 = Zt.double().numpy(), Yc.double().numpy()
            exact = (np.sum(y64 * (C @ y64)) - np.sum(z64 * (C @ z64))
                     - np.sum(2.0 * (C @ z64) * d) - 0.5 * Lt * np.sum(d * d))
            ub = fz + TS._vdot(gz, Yc - Zt) + 0.5 * Lt * TS._vdot(
                Yc - Zt, Yc - Zt)
            fails += 1
            exact_pass += bool(exact <= 0.0)
            port_fails += bool(val(Yc) > ub)
            Lt *= 2.0
    return steps, fails, exact_pass, port_fails, float(L_used)


STAGES = {("encoder", "NodeEncoder_0"): "encoder.node_encoder",
          ("encoder", "EdgeEncoder_0"): "encoder.edge_encoder",
          ("encoder", "GATv2Conv_0"): "encoder.convs.0",
          ("encoder", "GATv2Conv_0", "lin_dst"): "encoder.convs.0.lin_dst",
          ("encoder", "GATv2Conv_0", "lin_src"): "encoder.convs.0.lin_src",
          ("encoder", "GATv2Conv_0", "lin_edge"): "encoder.convs.0.lin_edge",
          ("encoder", "LayerNorm_0"): "encoder.norms.0",
          ("encoder", "GATv2Conv_1"): "encoder.convs.1",
          ("encoder", "GATv2Conv_1", "lin_dst"): "encoder.convs.1.lin_dst",
          ("encoder", "GATv2Conv_1", "lin_src"): "encoder.convs.1.lin_src",
          ("encoder", "LayerNorm_1"): "encoder.norms.1",
          ("encoder", "AttentionPooling_0", "Dense_0"):
              "encoder.attn_pool.dense_0",
          ("encoder", "AttentionPooling_0", "Dense_1"):
              "encoder.attn_pool.dense_1",
          ("encoder",): "encoder"}


def _port_stage_grads(case, tdt, w):
    """``_fixed_port_grads`` that also returns the gradient reaching each
    module of ``STAGES`` (float32 copies)."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    _, params, _, bt, _, _, coins = case
    pool = K.graph_pool

    def fixed(seg, x, score, keep=None):
        out = pool(seg, x, score, keep)
        n, d = x.shape
        ids = torch.as_tensor(np.asarray(bt.batch)[:n]).long()
        mx = torch.zeros((bt.num_graphs, d), dtype=x.dtype).index_add_(
            0, ids, x * torch.as_tensor(w[:n], dtype=x.dtype))
        return torch.cat([out[:, :d], mx, out[:, 2 * d:]], dim=1)

    m = net.RankSchedulePredictor(net.ModelConfig(**WIDE))
    m.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    m = m.to(tdt).train()
    grads = {}

    def hook(name):
        def fwd(mod, args, out):
            t = out[0] if isinstance(out, tuple) else out
            t.register_hook(lambda g: grads.__setitem__(
                name, g.float().numpy().copy()))
        return fwd

    for name in STAGES.values():
        m.get_submodule(name).register_forward_hook(hook(name))
    K.graph_pool = fixed
    try:
        train_case._port_loss(m, bt, coins, tdt)[0].backward()
    finally:
        K.graph_pool = pool
    return grads, {k: p.grad.double() for k, p in m.named_parameters()}


def _jax_stage_grads(case, jdt, w):
    """The gradient reaching each module of ``STAGES`` in the JAX package's
    step with the node fixed (an identity with a custom VJP after each
    module's call, through ``flax.linen.intercept_methods``)."""
    import flax.linen as nn
    store = {}

    def tap(name):
        @jax.custom_vjp
        def t(x):
            return x

        def bwd(_, g):
            jax.debug.callback(lambda v: store.__setitem__(
                name, np.asarray(v, np.float32)), g)
            return (g,)

        t.defvjp(lambda x: (x, None), bwd)
        return t

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = tuple(p.replace("Checkpoint", "")
                     for p in context.module.path)
        if (context.method_name == "__call__" and path in STAGES
                and not isinstance(out, tuple)):
            out = tap(STAGES[path])(out)
        return out

    with nn.intercept_methods(intercept):
        _fixed_jax_grads(case, jdt, w)
    return store


def departure_evidence(pick=(0, 1, 2)):
    """The second departure of the 4 x 128 step (``ROADMAP.md`` Queue 3,
    open): on the test graphs ``pick`` with the max pooling's node fixed,
    against the port's float64 step, (1) the gradient reaching each stage
    in the JAX package's float32 step and in the port's; (2) the port's
    float32 worst leaf and ``convs.0.lin_dst.weight`` with K11's plain
    backward evaluated in float64 on its float32 inputs, with its shift
    term summed over the slots as JAX's VJP forms it, and with the
    self-loops' edge feature formed in float64; (3) per softmax of the
    port's float32 forward, how far a destination's weights sum from 1."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    case = wide_batch(pick)
    w, g64 = port_float64_reference(case)
    s64, _ = _port_stage_grads(case, torch.float64, w)
    gc.collect()
    s32, _ = _port_stage_grads(case, torch.float32, w)
    j32 = _jax_stage_grads(case, jnp.float32, w)
    jax.clear_caches()
    gc.collect()
    for name in STAGES.values():
        ref = s64[name].astype(np.float64)
        n, scale = ref.shape[0], np.abs(ref).max()
        jx = j32[name][:n].reshape(ref.shape)
        print(f"4 x 128, test graphs {pick}, node fixed: gradient at "
              f"{name}, JAX float32 {np.abs(jx - ref).max() / scale:.2e}, "
              f"port float32 {np.abs(s32[name] - ref).max() / scale:.2e}",
              flush=True)
    del s64, s32, j32
    gc.collect()
    bwd, fill = K.gatv2_softmax_agg_bwd_plain, net.GNNEncoder.edge_fill

    def bwd64(g, *args):
        res = bwd(g, *(None if a is None else a.double() for a in args))
        return tuple(r.float() for r in res)

    def summed(g, w_src, w_dst, we, we_loop, att, keep, lse, out, dout,
               scores=None):
        # the shift term as JAX's VJP forms it: out = sum_e alpha_e x_e, so
        # <dout, out> is replaced by sum_e alpha_e dalpha_e over the slots
        xs, _, sc = K._gatv2_messages(g, w_src, w_dst, we, we_loop, att)
        sc = sc if scores is None else scores.to(sc.dtype)
        alpha = torch.exp(sc - lse[g.dst_ids])
        heads, ch = att.shape
        kp = torch.ones_like(alpha) if keep is None else keep
        dalpha = kp * torch.sum(dout.view(-1, heads, ch)[g.dst_ids] * xs,
                                dim=-1)
        d = torch.zeros((g.n, heads), dtype=alpha.dtype).index_add_(
            0, g.dst_ids, alpha * dalpha)
        # an out for which <dout, out> is that sum, head by head
        shift = (d - torch.sum(dout.view(-1, heads, ch)
                               * out.view(-1, heads, ch), dim=-1))
        norm = torch.sum(dout.view(-1, heads, ch) ** 2, dim=-1)
        out2 = out.view(-1, heads, ch) + (shift / torch.where(
            norm > 0, norm, 1.0))[..., None] * dout.view(-1, heads, ch)
        return bwd(g, w_src, w_dst, we, we_loop, att, keep, lse,
                   out2.reshape(out.shape), dout, scores=scores)

    def fill64(self, e, envelope=None, generator=None):
        return fill(self, e.double(), envelope, generator).to(e.dtype)

    for tag, patch in (("K11's plain backward in float64",
                        (K, "gatv2_softmax_agg_bwd_plain", bwd64)),
                       ("the shift term summed over the slots",
                        (K, "gatv2_softmax_agg_bwd_plain", summed)),
                       ("the self-loop feature in float64",
                        (net.GNNEncoder, "edge_fill", fill64))):
        mp = pytest.MonkeyPatch()
        mp.setattr(*patch)
        try:
            e = _leaf_errors(_fixed_port_grads(case, torch.float32, w), g64)
        finally:
            mp.undo()
        gc.collect()
        print(f"4 x 128, test graphs {pick}, node fixed, {tag}: port "
              f"float32 worst leaf {_worst(e)[0]} {_worst(e)[1]:.3e}, "
              f"convs.0.lin_dst.weight "
              f"{e['encoder.convs.0.lin_dst.weight']:.3e}", flush=True)
    sums = []
    soft = K._segment_softmax

    def record(scores, ids, n):
        a, lse = soft(scores, ids, n)
        tot = torch.zeros((n,) + tuple(scores.shape[1:]),
                          dtype=a.dtype).index_add_(0, ids, a)
        sums.append(float((tot[tot > 0] - 1).abs().max()))
        return a, lse

    mp = pytest.MonkeyPatch()
    mp.setattr(K, "_segment_softmax", record)
    try:
        with torch.no_grad():
            _port_grads_forward_only(case)
    finally:
        mp.undo()
    print(f"4 x 128, test graphs {pick}: the port's float32 softmax weights "
          f"of a destination sum to 1 within {sums} (GATv2 layers, then the "
          f"attention pooling)", flush=True)


K11_INPUTS = ("w_src", "w_dst", "we", "we_loop", "scores", "alpha", "out",
              "dout")


class _GatJax:
    """Stands for the ``jax`` name of ``ltr_lowrank_sdp_tpu.models.gatv2``:
    every attribute is jax's own, but ``vmap`` hands the scores entering the
    segment softmax of the first layer traced, and the weights leaving it,
    to ``keep(name, value)`` (outside the vmap: inside it a callback sees
    one head at a time)."""

    def __init__(self, keep):
        self.keep, self.calls = keep, 0

    def vmap(self, fun, **kw):
        mapped = jax.vmap(fun, **kw)

        def run(scores):
            first = self.calls == 0
            self.calls += 1
            alpha = mapped(scores)
            if first:
                self.keep("scores", scores)
                self.keep("alpha", alpha)
            return alpha

        return run

    def __getattr__(self, name):
        return getattr(jax, name)


def jax_layer0_values(case, w):
    """(values, gradients) of the JAX package's float32 step with the max
    node fixed by ``w``: ``values`` holds what K11 reads at GAT layer 0 as
    JAX forms it (its Dense outputs, its scores and softmax weights, its
    output and the gradient reaching it), as numpy arrays in JAX's layout
    (nodes and edges padded to the envelope, the self-loops after the
    edges), each the last value its step computed (the backward recomputes
    the layer: ``nn.remat``), and ``values["recomputed"]`` the names whose
    recomputed value differs from the forward's."""
    import flax.linen as nn
    from ltr_lowrank_sdp_tpu.models import gatv2 as jax_gatv2
    n_edges = int(case[3].edge_index.shape[1])
    e_pad = int(case[2].edge_index.shape[1])
    seen = {}

    def keep(name, v):
        jax.debug.callback(lambda a: seen.setdefault(name, []).append(
            np.asarray(a)), v)

    @jax.custom_vjp
    def tap(x):
        return x

    def tap_bwd(_, g):
        keep("dout", g)
        return (g,)

    tap.defvjp(lambda x: (x, None), tap_bwd)
    layer0 = ("encoder", "GATv2Conv_0")

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = tuple(p.replace("Checkpoint", "") for p in context.module.path)
        if context.method_name != "__call__":
            return out
        if path == layer0:
            keep("out", out)
            out = tap(out)
        elif path[:2] == layer0 and path[2:] in (("lin_src",), ("lin_dst",)):
            keep("w_" + path[2][4:], out)
        elif path == layer0 + ("lin_edge",):
            keep("we", out[:n_edges])
            keep("we_loop", out[e_pad])
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_gatv2, "jax", _GatJax(keep))
    try:
        with nn.intercept_methods(intercept):
            grads = _fixed_jax_grads(case, jnp.float32, w)
    finally:
        mp.undo()
    values = {k: v[-1] for k, v in seen.items()}
    values["recomputed"] = [k for k, v in seen.items()
                            if any(not np.array_equal(v[0], u) for u in v)]
    return values, grads


def _port_layout(g, name, v, n_edges, e_pad):
    """JAX's value ``v`` of K11's input ``name`` in the port's layout: the
    real nodes, the real edges, the CSR's slot order (a self-loop of node i
    is JAX's edge e_pad + i)."""
    if name in ("scores", "alpha"):
        erow, dst = g.erow.long(), g.dst_ids
        idx = torch.where(erow < n_edges, erow, e_pad + dst)
        return torch.as_tensor(v)[idx]
    if name in ("we", "we_loop"):
        return torch.as_tensor(v)
    return torch.as_tensor(v[:g.n])


def _k11_with(g, w_src, w_dst, we, we_loop, att, keep, lse, out, dout,
              scores=None, alpha=None, branch=None):
    """``kernels.gatv2_softmax_agg_bwd_plain`` with the softmax weights
    ``alpha`` given (None: its own) and the LeakyReLU's branch of every
    message (``msg >= 0``, (E', H, C) bool) given (None: its own);
    otherwise the same formulas, in the same order."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    heads, ch = att.shape
    hc = heads * ch
    dst = g.dst_ids
    xs, msg, s = K._gatv2_messages(g, w_src, w_dst, we, we_loop, att)
    scores = s if scores is None else scores.to(s.dtype)
    own = torch.exp(scores - lse[dst])
    alpha = own if alpha is None else alpha.to(own.dtype)
    kp = torch.ones_like(alpha) if keep is None else keep
    go = dout.view(-1, heads, ch)
    dalpha = kp * torch.sum(go[dst] * xs, dim=-1)
    dd = torch.sum(go * out.view(-1, heads, ch), dim=-1)
    ds = K._max_path(alpha * (dalpha - dd[dst]), scores, dst, g.n)
    pos = msg >= 0 if branch is None else branch
    act = torch.where(pos, msg, K.LEAKY_SLOPE * msg)
    dmsg = (ds[..., None] * att * torch.where(pos, 1.0, K.LEAKY_SLOPE)
            ).reshape(-1, hc)
    d_att = torch.sum(ds[..., None] * act, dim=0)
    zeros = torch.zeros((g.n, hc), dtype=w_src.dtype, device=w_src.device)
    d_w_dst = zeros.clone().index_add_(0, dst, dmsg)
    d_w_src = zeros.index_add_(
        0, g.src.long(),
        ((alpha * kp)[..., None] * go[dst]).reshape(-1, hc) + dmsg)
    erow = g.erow.long()
    real = erow < g.n_real
    d_we = torch.zeros_like(we).index_add_(0, erow[real], dmsg[real])
    return d_w_src, d_w_dst, d_we, torch.sum(dmsg[~real], dim=0), d_att


def _branches(args):
    """The LeakyReLU's branch (``msg >= 0``) of every slot's message, from
    K11's arguments (a dict)."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    return K._gatv2_messages(args["g"], *(args[k] for k in _Layer0.ARGS[:5])
                             )[1] >= 0


class _Layer0:
    """Stands for ``kernels.gatv2_softmax_agg_bwd_plain`` in a step: the
    second call of a backward (layer 0's: layer 1's comes first) goes to
    ``self.call(g, args)``, which defaults to the plain backward and may be
    replaced; with ``capture``, ``self.args`` keeps the last layer-0 call's
    arguments, scores and softmax weights; ``self.calls`` counts the
    calls."""

    ARGS = ("w_src", "w_dst", "we", "we_loop", "att", "keep", "lse", "out",
            "dout")

    def __init__(self, capture=False):
        from ltr_lowrank_sdp_torch.ops import kernels as K
        self.plain, self.capture = K.gatv2_softmax_agg_bwd_plain, capture
        self.calls, self.args, self.call = 0, None, None

    def __call__(self, g, *args):
        self.calls += 1
        if self.calls % 2:
            return self.plain(g, *args)
        named = dict(zip(self.ARGS, args))
        if self.capture:
            from ltr_lowrank_sdp_torch.ops import kernels as K
            s = K._gatv2_messages(g, *args[:5])[2]
            self.args = dict(named, g=g, scores=s,
                             alpha=torch.exp(s - named["lse"][g.dst_ids]))
        if self.call is None:
            return self.plain(g, *args)
        return self.call(g, named)


def _rel(x, ref):
    ref = torch.as_tensor(ref).double()
    return float((torch.as_tensor(x).double() - ref).abs().max()
                 / ref.abs().max())


def inputs_evidence(pick=(0, 1, 2)):
    """K11's inputs at GAT layer 0 one by one (``ROADMAP.md`` Queue 3): on
    the test graphs ``pick`` with the max pooling's node fixed, against the
    port's float64 step, (1) how far each input of the port's float32 step
    and of the JAX package's float32 step lies from the float64 one (its
    largest difference over the float64 value's largest magnitude); (2) the
    port's float32 worst leaf and ``convs.0.lin_dst.weight`` with each input
    of layer 0's K11 replaced by the JAX float32 step's value of the same
    tensor (the softmax weights ``alpha`` in place of the port's own), with
    the port's own weights in JAX's form ``ex / (sum + 1e-16)`` (the form of
    its plain forward), and with all of JAX's at once.  One float32 forward
    serves every variant: each is a backward of the same graph."""
    import time
    from ltr_lowrank_sdp_torch.ops import kernels as K
    case = wide_batch(pick)
    bt = case[3]
    n_edges = int(bt.edge_index.shape[1])
    e_pad = int(case[2].edge_index.shape[1])
    t0 = time.time()

    def stamp(what):
        print(f"[{time.time() - t0:7.0f} s] {what}", flush=True)

    ref = _Layer0(capture=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(K, "gatv2_softmax_agg_bwd_plain", ref)
    try:
        w, g64 = port_float64_reference(case)
    finally:
        mp.undo()
    ref64 = {k: ref.args[k] for k in K11_INPUTS}
    branch64 = _branches(ref.args)
    ref.args = None
    gc.collect()
    stamp("port float64 reference")
    jx, jgrads = jax_layer0_values(case, w)
    jax.clear_caches()
    je = _leaf_errors(jgrads, g64)
    del jgrads
    gc.collect()
    stamp(f"JAX float32 step: worst leaf {_worst(je)[0]} {_worst(je)[1]:.3e}, "
          f"convs.0.lin_dst.weight {je['encoder.convs.0.lin_dst.weight']:.3e}"
          f"; recomputed values that differ from the forward's: "
          f"{jx['recomputed']}")

    # one float32 forward, then a backward a variant
    _, params, _, _, _, _, coins = case
    m = net.RankSchedulePredictor(net.ModelConfig(**WIDE))
    m.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    m = m.to(torch.float32).train()
    pool = K.graph_pool

    def fixed(seg, x, score, keep=None):
        out = pool(seg, x, score, keep)
        n, d = x.shape
        ids = torch.as_tensor(np.asarray(bt.batch)[:n]).long()
        mx = torch.zeros((bt.num_graphs, d), dtype=x.dtype).index_add_(
            0, ids, x * torch.as_tensor(w[:n], dtype=x.dtype))
        return torch.cat([out[:, :d], mx, out[:, 2 * d:]], dim=1)

    K.graph_pool = fixed
    try:
        total = train_case._port_loss(m, bt, coins, torch.float32)[0]
    finally:
        K.graph_pool = pool
    stamp("port float32 forward")
    layer0 = _Layer0(capture=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(K, "gatv2_softmax_agg_bwd_plain", layer0)

    def backward(tag, call=None):
        layer0.call = call
        for p in m.parameters():
            p.grad = None
        total.backward(retain_graph=True)
        e = _leaf_errors({k: p.grad.double() for k, p in m.named_parameters()},
                         g64)
        stamp(f"4 x 128, test graphs {pick}, node fixed, {tag}: port float32 "
              f"worst leaf {_worst(e)[0]} {_worst(e)[1]:.3e}, "
              f"convs.0.lin_dst.weight "
              f"{e['encoder.convs.0.lin_dst.weight']:.3e}")
        return e

    try:
        backward("as it is")
        got, layer0.capture = layer0.args, False
        g = got["g"]
        jax_in = {k: _port_layout(g, k, jx[k], n_edges, e_pad)
                  for k in K11_INPUTS}
        del jx
        gc.collect()
        for k in K11_INPUTS:
            print(f"K11's {k} at layer 0 against the port's float64 value: "
                  f"port float32 {_rel(got[k], ref64[k]):.3e}, JAX float32 "
                  f"{_rel(jax_in[k], ref64[k]):.3e}", flush=True)
        del ref64
        gc.collect()
        # where the float32 messages take the other branch of the LeakyReLU
        # than the float64 ones (a jump of the function, as the max
        # pooling's node is)
        real = (g.erow < g.n_real)[:, None, None]
        for name, a in (("port", got), ("JAX", dict(got, **jax_in))):
            flip = _branches(a) != branch64
            print(f"layer 0's messages on the other LeakyReLU branch than "
                  f"the float64 step's: {name} float32 "
                  f"{int((flip & real).sum())} on edges, "
                  f"{int((flip & ~real).sum())} on self-loops",
                  flush=True)
            del flip
        got_flip = _branches(got) != branch64
        where = torch.nonzero(got_flip)
        for e, h, c in where[:8].tolist():
            kind = "edge" if int(g.erow[e]) < g.n_real else "self-loop"
            print(f"  port flip: slot {e} (node {int(g.dst_ids[e])} <- "
                  f"{int(g.src[e])}, {kind}), head {h}, channel {c}",
                  flush=True)
        del got_flip, where
        gc.collect()

        def swapped(names, own_form=False, branch=None):
            def call(g, a):
                a = dict(a)
                extra = {} if branch is None else {"branch": branch}
                for k in names:
                    if k == "alpha":
                        extra["alpha"] = jax_in["alpha"]
                    elif k == "scores":
                        extra["scores"] = jax_in["scores"]
                    else:
                        a[k] = jax_in[k]
                if own_form:
                    s = K._gatv2_messages(
                        g, *(a[k] for k in _Layer0.ARGS[:5]))[2]
                    extra["alpha"] = K._segment_softmax(s, g.dst_ids, g.n)[0]
                return _k11_with(g, *(a[k] for k in _Layer0.ARGS), **extra)
            return call

        backward("the copy of the plain backward (the same bits)",
                 swapped(()))
        for k in K11_INPUTS:
            backward(f"JAX's {k}", swapped((k,)))
        backward("the port's own alpha in JAX's form ex / (sum + 1e-16)",
                 swapped((), own_form=True))
        backward("all of JAX's inputs", swapped(K11_INPUTS))
        backward("the float64 step's LeakyReLU branches",
                 swapped((), branch=branch64))
        backward("JAX's w_src with the float64 step's LeakyReLU branches",
                 swapped(("w_src",), branch=branch64))
        backward("all of JAX's inputs with the float64 step's LeakyReLU "
                 "branches", swapped(K11_INPUTS, branch=branch64))
    finally:
        mp.undo()
    assert layer0.calls % 2 == 0


class _Branches:
    """Stands for ``kernels.gatv2_softmax_agg_bwd_plain`` in a step of the
    2-layer model (its backward calls layer 1 first, then layer 0): with
    ``capture``, ``self.masks[layer]`` keeps each layer's LeakyReLU
    branches (``msg >= 0``) of the last call; given ``masks``, each layer's
    backward takes its messages' branches from them (``_k11_with``)."""

    def __init__(self, masks=None, capture=False):
        from ltr_lowrank_sdp_torch.ops import kernels as K
        self.plain, self.capture = K.gatv2_softmax_agg_bwd_plain, capture
        self.masks, self.calls = ({} if masks is None else masks), 0
        self.fixed = masks is not None

    def __call__(self, g, *args):
        self.calls += 1
        layer = 1 if self.calls % 2 else 0
        if self.capture:
            self.masks[layer] = _branches(dict(zip(_Layer0.ARGS, args), g=g))
        if not self.fixed:
            return self.plain(g, *args)
        return _k11_with(g, *args, branch=self.masks[layer])


def _jax_masks(case, masks):
    """The port's per-layer branches (``_Branches.masks``) in JAX's layout:
    a real edge's slot at its edge row, node i's self-loop at e_pad + i;
    the envelope's padded edges and nodes, which reach no loss, True."""
    bt, bj = case[3], case[2]
    g = _edge_csr(bt)
    n_edges = int(bt.edge_index.shape[1])
    e_pad, n_pad = int(bj.edge_index.shape[1]), int(bj.x.shape[0])
    erow, dst = g.erow.long(), g.dst_ids
    idx = torch.where(erow < n_edges, erow, e_pad + dst).numpy()
    out = []
    for layer in sorted(masks):
        m = np.ones((e_pad + n_pad,) + tuple(masks[layer].shape[1:]), bool)
        m[idx] = masks[layer].numpy()
        out.append(m)
    return out


def _edge_csr(bt):
    """The port's CSR of the batch's edges with their self-loops."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    return K.EdgeCSR.from_edge_index(
        torch.as_tensor(np.asarray(bt.edge_index)).long(), int(bt.x.shape[0]))


def branch_evidence(pick):
    """The 4 x 128 step on the test graphs ``pick`` with the max pooling's
    node fixed (``fixed_node_evidence``'s measure), then with every GATv2
    message's LeakyReLU branch fixed too, to the float64 step's, in the
    JAX package's float32 step (``_GatNn``: forward and VJP) and in the
    port's (its backward: the forward's own branch moves a score by under
    1e-7 of it): a message
    within float32 rounding of 0 takes the other branch in float32 than in
    float64, a jump of the function (0.8 att ds at that slot), as the max
    pooling's node is.  The worst leaves and the largest port / JAX ratio
    at one leaf, against the JAX float64 step (the port's on a batch with
    graph 2)."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    case = wide_batch(pick)
    cap = _Branches(capture=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(K, "gatv2_softmax_agg_bwd_plain", cap)
    try:
        w, g64 = port_float64_reference(case)
    finally:
        mp.undo()
    masks, ref = dict(cap.masks), "port"
    del cap
    gc.collect()
    if 2 not in pick:
        w = float64_max_nodes(case)
        ref, g64 = "JAX", _fixed_jax_grads(case, jnp.float64, w)
    jm = _jax_masks(case, masks)
    errs = {"JAX": _leaf_errors(_fixed_jax_grads(case, jnp.float32, w),
                                g64)}
    jax.clear_caches()
    errs["JAX, branches fixed"] = _leaf_errors(
        _fixed_jax_grads(case, jnp.float32, w, jm), g64)
    del jm
    jax.clear_caches()
    gc.collect()
    errs["port"] = _leaf_errors(_fixed_port_grads(case, torch.float32, w),
                                g64)
    mp = pytest.MonkeyPatch()
    mp.setattr(K, "gatv2_softmax_agg_bwd_plain", _Branches(masks))
    try:
        errs["port, branches fixed"] = _leaf_errors(
            _fixed_port_grads(case, torch.float32, w), g64)
    finally:
        mp.undo()
    gc.collect()
    for name, e in errs.items():
        worst = _worst(e)
        base = "JAX, branches fixed" if "fixed" in name else "JAX"
        ratio = ("" if name.startswith("JAX") else
                 ", largest port / JAX at one leaf %.2f (%s)"
                 % leaf_ratio(e, errs[base]))
        print(f"4 x 128, test graphs {pick} by size, max node fixed "
              f"({ref} float64 reference): {name}: float32 worst leaf "
              f"{worst[0]} {worst[1]:.3e}, convs.0.lin_dst.weight "
              f"{e['encoder.convs.0.lin_dst.weight']:.3e}{ratio}", flush=True)


def _port_grads_forward_only(case):
    _, params, _, bt, _, _, coins = case
    m = net.RankSchedulePredictor(net.ModelConfig(**WIDE))
    m.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    train_case._port_loss(m.to(torch.float32).train(), bt, coins,
                          torch.float32)


EVIDENCE = ("hallar", "unfixed", "fixed", "departure", "inputs", "branches",
            "widths", "stages")


def evidence(parts=EVIDENCE):
    """The numbers of the module docstring, of ``hallar/solver.py``'s
    ``STOP_TOL_EPS`` and of ``ROADMAP.md`` Queue 3, in ``parts``:
    ``hallar``, the JAX float32 solve over 64 orders of C's entries and the
    nudged Y0, the port's over the same at stop floors of 1, 2, 4 and 8
    epsilons, JAX's failed backtracking tests on the file order;
    ``unfixed``, the 4 x 128 step's worst leaves on four batches of the
    test split's three graphs (0-1, 0-2, 1-2 and all three by size; a batch
    with the 23,028-node graph takes about 52 GB and five minutes on one
    thread); ``fixed``, the same batches with the max pooling's node fixed
    (``fixed_node_evidence``: about 27 GB and 15 minutes a batch with that
    graph); ``departure``, :func:`departure_evidence` on the three graphs
    (about 35 GB, 40 minutes); ``inputs``, :func:`inputs_evidence` on the
    three graphs (about 35 GB; 10 minutes on 6 threads); ``branches``,
    :func:`branch_evidence` on the four batches (about 25 minutes on 6
    threads); ``widths``, with ``chip_smoke.py``'s model
    (r5_theta's config at that width, ``init_params`` weights), the CPU's
    float32 steps at its three wide widths on the two-graph batch (several
    minutes); ``stages``, :func:`stages` on the three graphs."""
    if "fixed" in parts:
        for pick in ((0, 1), (0, 2), (1, 2), (0, 1, 2)):
            fixed_node_evidence(pick)
            jax.clear_caches()
            gc.collect()
    if "departure" in parts:
        departure_evidence()
    if "inputs" in parts:
        inputs_evidence()
    if "branches" in parts:
        for pick in ((0, 1), (0, 2), (1, 2), (0, 1, 2)):
            branch_evidence(pick)
            jax.clear_caches()
            gc.collect()
    if "stages" in parts:
        stages()
    if "hallar" in parts:
        hallar_evidence()
    if "unfixed" in parts:
        for pick in ((0, 1), (0, 2), (1, 2), (0, 1, 2)):
            case = wide_batch(pick)
            g64 = _jax_grads(case, jnp.float64)
            for name, g in (("JAX", _jax_grads(case, jnp.float32)),
                            ("port", _port_grads(case, torch.float32))):
                worst = max(_leaf_errors(g, g64).items(),
                            key=lambda kv: kv[1])
                print(f"4 x 128, test graphs {pick} by size: {name} "
                      f"float32 worst leaf {worst[0]} {worst[1]:.3e}",
                      flush=True)
    if "widths" in parts:
        width_evidence()


def hallar_evidence():
    cases = [(None, None)] + [(s, None) for s in range(64)] + [
        (None, _nudged_y0())]
    mp = pytest.MonkeyPatch()
    runs = jax_stop_steps(mp, cases)
    mp.undo()
    steps = [s[0] for s, _ in runs]
    print(f"JAX float32 stop steps: file order {steps[0]}, 64 orders "
          f"{sorted(steps[1:-1])}, nudged Y0 {steps[-1]}; median of the "
          f"orders {np.median(steps[1:-1])}", flush=True)
    n, fails, exact_pass, port_fails, L = failed_tests()
    print(f"JAX's file order: {n} steps, {fails} failed backtracking tests, "
          f"{exact_pass} of them pass in exact arithmetic, the port's "
          f"evaluation fails {port_fails} of them; L at the stop {L:g}",
          flush=True)
    floor = TS.STOP_TOL_EPS
    try:
        for eps in (1.0, 2.0, 4.0, 8.0):
            TS.STOP_TOL_EPS = eps
            port = [port_solve(seed, y0).fista_steps for seed, y0 in cases]
            print(f"port float32 stop steps, floor {eps:g} eps: file order "
                  f"{port[0]}, nudged Y0 {port[-1]}, 64 orders at most "
                  f"{max(port[1:-1])}, median {np.median(port[1:-1])}",
                  flush=True)
    finally:
        TS.STOP_TOL_EPS = floor


def width_evidence():
    import chip_smoke
    from ltr_lowrank_sdp_torch.ops import kernels as K
    cpu = torch.device("cpu")
    for hidden, heads in (*chip_smoke.WIDE_STEPS, chip_smoke.SMALL_STEP):
        setup = chip_smoke._train_setup(hidden, heads, small=True)
        g64 = chip_smoke._train_step(K, setup, cpu, torch.float64)[1]
        g32 = chip_smoke._train_step(K, setup, cpu, torch.float32)[1]
        worst = max(chip_smoke._leaf_errors(g32, g64)[0].items(),
                    key=lambda kv: kv[1])
        print(f"chip_smoke's model at {setup[4]}, two-graph batch: the CPU's "
              f"float32 step's worst leaf {worst[0]} {worst[1]:.3e}",
              flush=True)


def stages(pick=(0, 1, 2)):
    """The port's 4 x 128 step on the test graphs ``pick`` in float32 and in
    float64: each encoder stage's output and the gradient that reaches it
    (max difference over the float64 one's largest magnitude), and per
    graph the channels whose max pooling picks another node in float32
    than in float64 and the channels whose float64 maximum is an exact tie
    (a jump of the reference's own function: the pooled gradient lands on
    the other node)."""
    _, params, _, bt, _, _, coins = wide_batch(pick)
    names = ["encoder.node_encoder", "encoder.edge_encoder",
             "encoder.convs.0", "encoder.norms.0", "encoder.convs.1",
             "encoder.norms.1", "decoder"]
    from ltr_lowrank_sdp_torch.ops import kernels as K
    pool = K.graph_pool

    def run(dt):
        m = net.RankSchedulePredictor(net.ModelConfig(**WIDE))
        m.load_state_dict(checkpoint.params_from_flax(
            jax.tree.map(np.asarray, params)))
        m = m.to(dt).train()
        acts, grads = {}, {}

        def hook(name):
            def fwd(mod, args, out):
                t = out[0] if isinstance(out, tuple) else out
                acts[name] = t.detach().double()
                t.register_hook(lambda g: grads.__setitem__(name, g.double()))
            return fwd

        for name in names:
            m.get_submodule(name).register_forward_hook(hook(name))

        def pooled(seg, x, score, keep=None):
            acts["pool input"] = x.detach().double()
            return pool(seg, x, score, keep)

        K.graph_pool = pooled
        try:
            train_case._port_loss(m, bt, coins, dt)[0].backward()
        finally:
            K.graph_pool = pool
        return acts, grads

    (a64, g64), (a32, g32) = run(torch.float64), run(torch.float32)

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max())

    for name in names:
        out, grad = rel(a32[name], a64[name]), rel(g32[name], g64[name])
        print(f"4 x 128, test graphs {pick}: {name} output {out:.2e}, its "
              f"gradient {grad:.2e} (float32 against float64)", flush=True)
    batch = torch.as_tensor(np.asarray(bt.batch)).long()
    for b in range(len(pick)):
        x64 = a64["pool input"][batch[:a64["pool input"].shape[0]] == b]
        x32 = a32["pool input"][batch[:a32["pool input"].shape[0]] == b]
        top = x64.topk(min(2, x64.shape[0]), dim=0).values
        print(f"graph {pick[b]} ({x64.shape[0]} nodes): the max pooling "
              f"picks another node in float32 in "
              f"{int((x64.argmax(0) != x32.argmax(0)).sum())} of "
              f"{x64.shape[1]} channels; exact ties at the float64 maximum "
              f"in {int((top[0] == top[-1]).sum())}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(int(os.environ.get("F32_FAULT_THREADS", "1")))
    evidence(sys.argv[1:] or EVIDENCE)
