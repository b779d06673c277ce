"""The port's repaired faults against the reference's behaviour.

* One stop decision for every rank of a sharded solve: two gloo ranks solve
  ``random_maxcut_problem(48, 5, 7)`` constraint-sharded while rank 1's
  clock jumps past the time limit at its k-th ALM outer iteration (then at
  its k-th ADMM iteration) and rank 0's never does.  Both ranks must end
  with the status and counts of an unsharded solve whose own clock jumps at
  the same iteration, and neither may wait in a collective the other never
  reaches (the ranks' collectives time out after ``HANG_S`` seconds).  The
  sharded ranks run the eager loops, the unsharded solve the device-resident
  ones; both read the clock where a chunk of ADMM iterations ends.
* GNN widths past 256 channels a row, which the card refused: K9's launch
  plan (``k9_plan`` / ``k9_plans``) over every head width and the source's
  instantiations, K11's head groups (``k11_groups``), K10 / K12's column
  blocks at d = 384 composed from the plain version per block against the
  unsplit plain version (1e-12), and the predictor at hidden 288 (3 x 96),
  512 (8 x 64 and 4 x 128) and 300 (1 x 300) against the JAX model with the
  same parameters: the forward in float32 to 1e-5, one step's gradients in
  float64 to 1e-4 of each leaf (``test_torch_train.py``'s tolerances).  The kernels themselves
  at these widths are ``-m cuda`` cases of ``test_torch_kernels.py``.
* HALLaR's float32 ``<C, YY^T>``: ``test_torch_hallar_solve.py``.
"""

import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.data import loader as jax_loader
from ltr_lowrank_sdp_tpu.models import net as jax_net
from ltr_lowrank_sdp_torch import train

from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
from ltr_lowrank_sdp_torch.data import loader
from ltr_lowrank_sdp_torch.models import checkpoint, net
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.parallel.launch import spawn
from ltr_lowrank_sdp_torch.parallel.mesh import make_mesh
from ltr_lowrank_sdp_torch.solver import admm as admm_mod
from ltr_lowrank_sdp_torch.solver import alm as alm_mod
from ltr_lowrank_sdp_torch.solver import driver as driver_mod
from ltr_lowrank_sdp_torch.solver.common import own_flags
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.solver.logging import TrajectoryLogger
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem
from tests.test_torch_train import (T, TF_RATIO, _jax_loss, _port_loss,
                                    datasets)  # noqa: F401 (a fixture)

HANG_S = 60.0           # a collective that waits longer fails its rank
EXPIRE_AT = {"alm": 2, "admm": 5}


def _expire_clock(phase: str, k: int) -> None:
    """From this process's k-th ``phase`` iteration on (ALM outer iterations
    counted by ``ALMPhase.record``, ADMM iterations by the stats rows the
    trajectory logger records, one an iteration in either loop), the
    solver's clock reads a day later."""
    seen = [0]
    cls, name = ((alm_mod.ALMPhase, "record") if phase == "alm"
                 else (TrajectoryLogger, "record_admm_row"))
    orig = getattr(cls, name)

    def counted(self, *a, **kw):
        seen[0] += 1
        return orig(self, *a, **kw)

    setattr(cls, name, counted)
    real = time.time
    clock = types.SimpleNamespace(
        time=lambda: real() + (86400.0 if seen[0] >= k else 0.0),
        perf_counter=time.perf_counter)
    for mod in (driver_mod, alm_mod, admm_mod):
        mod.time = clock


def _summary(res):
    return (res.status.name, res.alm_outer_iters, res.alm_inner_iters,
            res.admm_iters, res.cg_iters, res.final_ranks)


def _solve(mesh=None):
    prob = random_maxcut_problem(48, avg_degree=5, seed=7)
    # phase1_tol 0.1 leaves ADMM 23 iterations (5 ALM outer iterations)
    return Solver(prob, SolverParams(time_sec_limit=3600.0, phase1_tol=0.1),
                  device="cpu", mesh=mesh).solve()


def _sharded_rank(phase: str, k: int):
    mesh = make_mesh(device="cpu")
    if mesh.rank == 1:
        _expire_clock(phase, k)
    return _summary(_solve(mesh))


def _unsharded(phase: str, k: int):
    _expire_clock(phase, k)
    return _summary(_solve())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _restore_clock():
    saved = [(m, m.time) for m in (driver_mod, alm_mod, admm_mod)]
    methods = [(alm_mod.ALMPhase, "record", alm_mod.ALMPhase.record),
               (TrajectoryLogger, "record_admm_row",
                TrajectoryLogger.record_admm_row)]
    yield
    for m, t in saved:
        m.time = t
    for cls, name, fn in methods:
        setattr(cls, name, fn)


@pytest.mark.parametrize("phase", ["alm", "admm"])
def test_a_sharded_solve_stops_on_one_decision_of_all_ranks(phase,
                                                            _restore_clock):
    k = EXPIRE_AT[phase]
    want = _unsharded(phase, k)
    assert want[0] == SolverStatus.TIME_LIMIT.name
    # the time limit ends the phase it names: ALM before any ADMM iteration
    assert (want[3] == 0) == (phase == "alm")
    t = time.time()
    got = spawn(_sharded_rank, 2, (phase, k), timeout=HANG_S)
    assert time.time() - t < HANG_S
    assert got[0] == got[1] == want


def test_an_unsharded_solve_agrees_with_itself_alone():
    """Without a mesh the stop flags are the solve's own: no collective, no
    host read (the solve's sync count does not move)."""
    solver = Solver(random_maxcut_problem(48, avg_degree=5, seed=7),
                    device="cpu")
    assert solver.agree is own_flags
    assert own_flags(True, 0) == (True, False)
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------- #
# GNN widths past 256 channels a row: K9's plan, K11's head groups, K10 /
# K12's column blocks, and the model at hidden 288, 512 and 300
# --------------------------------------------------------------------------- #


def _k9_source_cases():
    """(v, p, s, b) of the source's K9_CASE list, and (v, 0, 1, 1) of each
    wide instance it dispatches (``launch_wide<V>``)."""
    src = (K.CSRC_DIR / "gatv2_softmax_agg.cu").read_text()
    return ({tuple(int(x) for x in m.split(","))
             for m in re.findall(r"K9_CASE\((\d+, \d+, \d+, \d+)\)", src)}
            | {(int(v), 0, 1, 1)
               for v in re.findall(r"launch_wide<(\d)>\(train", src)})


def test_k9_instances_are_the_sources():
    assert _k9_source_cases() == K.K9_INSTANCES


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 8, 16, 33])
def test_k9_plan_covers_every_width(heads):
    """For every head of 1 to 256 channels: the plan is a function of (heads,
    ch), every plan of the sweep is instantiated and shares its lanes and
    groups, P channels over lph lanes reach the head, a group's lanes fit a
    sub-warp, the groups hold every head, vector loads only where the head's
    channels are a multiple of them.  A wider head takes the wide kernel, a
    warp a head."""
    for ch in range(1, K.K9_MAX_HEAD + 1):
        plan = K.k9_plan(heads, ch)
        assert plan == K.k9_plan(heads, ch)
        plans = K.k9_plans(heads, ch)
        assert plans[0] == plan and len(set(plans)) == len(plans)
        for q in plans:
            assert (q.v, q.p, q.s, q.b) in K.K9_INSTANCES
            assert (q.p, q.lph, q.hpg, q.groups) == (
                plan.p, plan.lph, plan.hpg, plan.groups)
            assert q.s <= plan.s and 32 % q.s == 0 and ch % q.v == 0
        assert plan.p in (4, 8) and plan.p * plan.lph >= ch
        assert plan.p == 4 or plan.p * plan.lph // 2 < ch
        assert plan.hpg * plan.lph <= 32 // plan.s
        assert plan.groups * plan.hpg >= heads > (plan.groups - 1) * plan.hpg
        assert plan.v == (4 if ch % 4 == 0 else 2 if ch % 2 == 0 else 1)
    for ch in (257, 300, 384, 1001):
        plan = K.k9_plan(heads, ch)
        assert (plan.p, plan.s, plan.b, plan.lph, plan.hpg, plan.groups) == (
            0, 1, 1, 32, 1, heads)
        assert plan.v == (4 if ch % 4 == 0 else 2 if ch % 2 == 0 else 1)
        plans = K.k9_plans(heads, ch)
        assert plans[0] == plan and all(
            (q.v, q.p, q.s, q.b) in K.K9_INSTANCES for q in plans)
    with pytest.raises(ValueError):
        K.k9_plan(heads, 0)


@pytest.mark.parametrize("heads,ch,groups", [
    (4, 16, [(0, 4)]), (4, 64, [(0, 4)]), (3, 96, [(0, 2), (2, 1)]),
    (8, 64, [(0, 4), (4, 4)]), (33, 8, [(0, 32), (32, 1)]),
    (1, 256, [(0, 1)]), (5, 256, [(h, 1) for h in range(5)]),
    (1, 300, [(0, 1)]), (2, 600, [(0, 1), (1, 1)])])
def test_k11_head_groups(heads, ch, groups):
    """K11's calls take the heads in order, each group one call's lanes
    (``gatv2_lanes``), one call where the heads fit it; a head past 256
    channels is a call of the wide kernels (p = 0, 8 sign words a pass of
    256 channels)."""
    assert K.k11_groups(heads, ch) == groups
    for _, hg in groups:
        plan = K.k11_plan(hg, ch)
        if ch > K.K9_MAX_HEAD:
            assert hg == 1 and (plan.s, plan.p) == (1, 0)
            assert plan.words == 8 * -(-ch // 256)
            continue
        lph, per_lane = K.gatv2_lanes(hg, ch)
        assert per_lane <= K.K9_MAX_PER_LANE


def test_k10_k12_column_blocks_compose_the_unsplit_plain_version():
    """K10 / K12's split at d = 384 (blocks of 256 and 128 columns), each
    block through the plain version: the blocks' poolings and dx are the
    unsplit ones column by column, the attention softmax's stats are every
    block's, and dscore is the sum of the blocks' (its dots split by
    column)."""
    rng = np.random.default_rng(384)
    d, counts = 384, (300, 1, 260)
    seg = K.GraphSegments.from_counts(counts, "cpu")
    n = sum(counts)
    x = torch.tensor(np.round(2.0 * rng.standard_normal((n, d))))
    score = torch.tensor(3.0 * rng.standard_normal(n))
    keep = torch.tensor(rng.choice([0.0, 1.25], size=n))
    out, stats, ties = K._graph_pool_plain(seg, x, score, keep)
    dout = torch.tensor(rng.standard_normal(out.shape))
    dx, dscore = K.graph_pool_bwd_plain(seg, x, score, keep, out, stats, ties,
                                        dout)
    blocks = [(c0, min(d, c0 + K.K10_MAX_D)) for c0 in
              range(0, d, K.K10_MAX_D)]
    assert blocks == [(0, 256), (256, 384)]
    dscore_sum = torch.zeros(n, dtype=torch.float64)
    for c0, c1 in blocks:
        xb = x[:, c0:c1].contiguous()
        ob, sb, tb = K._graph_pool_plain(seg, xb, score, keep)
        w = c1 - c0
        for part in range(3):
            torch.testing.assert_close(
                ob[:, part * w:(part + 1) * w],
                out[:, part * d + c0:part * d + c1], rtol=1e-12, atol=1e-12)
        assert torch.equal(sb, stats) and torch.equal(tb, ties[:, c0:c1])
        db = torch.cat([dout[:, part * d + c0:part * d + c1]
                        for part in range(3)], dim=1)
        dxb, dsb = K.graph_pool_bwd_plain(seg, xb, score, keep, ob, sb, tb,
                                          db)
        torch.testing.assert_close(dxb, dx[:, c0:c1], rtol=1e-12, atol=1e-12)
        dscore_sum += dsb
    torch.testing.assert_close(dscore_sum, dscore, rtol=1e-12, atol=1e-12)


WIDE = {"288=3x96": dict(hidden_dim=288, num_heads=3),
        "512=8x64": dict(hidden_dim=512, num_heads=8),
        "512=4x128": dict(hidden_dim=512, num_heads=4),
        "300=1x300": dict(hidden_dim=300, num_heads=1)}
WIDE_CFG = dict(edge_dim=8, global_dim=8, num_gnn_layers=2,
                decoder_hidden_dim=16, decoder_num_layers=2, max_seq_len=T,
                dropout=0.0)


@pytest.fixture(scope="module")
def wide_cases(datasets):
    """Per width: the JAX model, its parameters (biases moved off zero), the
    two packages' collated batch of the three smallest dataset graphs and
    the JAX teacher-forcing coins (``test_torch_train.small_case``'s
    recipe)."""
    ds_j, ds_t, order = datasets
    bj = jax_loader.collate([ds_j.get(i) for i in order[:3]],
                            pad_graphs_to=8)
    bt = loader.collate([ds_t.get(i) for i in order[:3]], pad_graphs_to=8)
    args = [jnp.asarray(a) for a in (bj.x, bj.edge_index, bj.edge_attr,
                                     bj.batch, bj.global_attr)]
    tf_rng = jax.random.fold_in(jax.random.PRNGKey(5), 17)
    coins = np.asarray(jax.vmap(
        lambda t: jax.random.uniform(jax.random.fold_in(tf_rng, t)))(
        jnp.arange(T)))
    out = {}
    for name, kw in WIDE.items():
        model = jax_net.RankSchedulePredictor(
            jax_net.ModelConfig(**kw, **WIDE_CFG))
        params = model.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)}, *args,
                            bj.num_graphs)
        params = jax.tree.map(lambda p: p + 0.05 if p.ndim == 1 else p,
                              params)
        out[name] = (model, params)
    return out, bj, bt, args, tf_rng, coins


def _wide_port(name, params, dtype):
    m = net.RankSchedulePredictor(net.ModelConfig(**WIDE[name], **WIDE_CFG))
    m.load_state_dict(checkpoint.params_from_flax(
        jax.tree.map(np.asarray, params)))
    return m.to(dtype).train()


@pytest.mark.parametrize("step", ["forward", "gradients"])
@pytest.mark.parametrize("name", list(WIDE))
def test_model_past_256_channels_matches_jax(wide_cases, name, step,
                                             one_thread):
    """The port's predictor at a width K9-K12 refused on the card before
    (hidden 288 = 3 heads x 96, 512 = 8 x 64 and 4 x 128, 300 = 1 x 300),
    against the JAX model with
    the same parameters (``params_from_flax``): the teacher-forced forward
    and loss in float32 to 1e-5, and one training step's gradients in
    float64, every leaf to 1e-4 of its largest value (the tolerances of
    ``test_torch_train.py``)."""
    models, bj, bt, args, tf_rng, coins = wide_cases
    model, params = models[name]
    if step == "forward":
        want_loss, (preds, ll, ir) = _jax_loss(model, args, bj, tf_rng,
                                               jnp.float32)(params)
        m = _wide_port(name, params, torch.float32)
        with torch.no_grad():
            t = train.batch_tensors(bt, "cpu")
            got = m(t["x"], t["edge_index"], t["edge_attr"], t["batch"],
                    t["global_attr"], bt.num_graphs, t["schedule"],
                    t["mask"], TF_RATIO, coins=torch.tensor(coins),
                    envelope=bt.envelope)
            got_loss, _ = _port_loss(m, bt, coins, torch.float32)
        for a, b in zip(got, (preds, ll, ir)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
        return
    params = jax.tree.map(lambda p: p.astype(jnp.float64), params)
    args = [a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
            else a for a in args]
    (want_loss, _), grads = jax.value_and_grad(
        _jax_loss(model, args, bj, tf_rng, jnp.float64), has_aux=True)(params)
    m = _wide_port(name, params, torch.float64)
    got_loss, _ = _port_loss(m, bt, coins, torch.float64)
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               rtol=1e-9)
    want = checkpoint.params_from_flax(
        jax.tree.map(lambda g: np.asarray(g, np.float64), grads))
    got = {k: p.grad.double() for k, p in m.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        if k == "encoder.attn_pool.dense_1.bias":       # exactly 0
            assert float(w.abs().max()) <= 1e-12 * largest
            assert float(got[k].abs().max()) <= 1e-12 * largest, k
        else:
            assert err <= 1e-4 * float(w.abs().max()), (k, err)
