"""The parallel modes of the port on ``torch.distributed`` (gloo, CPU)
against the JAX package's sharded ones on conftest's 8-device virtual mesh.

The port's ranks are real processes: each world size is started once for
the whole module (``launch.spawn``, a ``file://`` store, one torch thread
per rank), and every rank runs every case and returns its arrays.

* ``MeshConeOps`` on ``tests/test_meshops.py``'s cones (sparse and diag,
  n, m, r = 37, 23, 5, seeds 3 and 5) against the JAX ``MeshConeOps`` to
  1e-12 at world sizes 2 and 3.  The sharded ``constr_vals`` and
  ``apply_a`` also equal the port's unsharded operators bit for bit (one
  owner per output, exact zeros from the other ranks), and every rank and
  both world sizes return the same bits.
* The sharded ``Solver`` against JAX's ``Solver(mesh=mesh8)`` from the
  same starting factors, with ``tests/test_meshops.py``'s tolerances:
  ``random_maxcut_problem(48, 5, 7)`` (status equal; pobj rtol 1e-9, pinf
  and gap atol 1e-10) and ``random_multiblock_problem((16, 12), 14, 11)``
  at ``phase2_tol=1e-6`` (pobj 1e-8, gap and pinf atol 1e-9).  Both blocks
  of the latter are dense-A (n < 20), which neither package shards: that
  case holds the delegating path.
* The sharded solves take the port's unsharded path: the same status and
  counts, pobj to 1e-9.
* A rank that owns nothing: world size 3 on a 2-constraint cone.
* ``mesh_axis="row"`` on a mesh without a ``row`` axis raises (the row
  mode itself: ``tests/test_torch_row_shard.py``).
* World size 4 (what ``chip_smoke.py --multi-card`` runs over NCCL as
  ``[constr-nccl4]``): on a cone of phase 5's matrix-completion family each
  sharded operator gives world size 1's bits on every rank, and
  ``constr_vals`` / ``apply_a`` the unsharded operators' bits; phase 4's
  family (a Delaunay MaxCut with phase 4's flags) solved sharded gives the
  unsharded solve's status and counts, pobj within 1e-9, world size 1's
  numbers exactly, every rank rank 0's.
* An NCCL world larger than the card count is refused by ``spawn`` and
  ``make_mesh`` with the counts, before any rank starts or binds a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ltr_lowrank_sdp_tpu.config import SolverParams as JaxSolverParams
from ltr_lowrank_sdp_tpu.ops.coneops import ConeOps as JaxConeOps
from ltr_lowrank_sdp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ltr_lowrank_sdp_tpu.parallel.meshops import (
    MeshConeOps as JaxMeshConeOps)
from ltr_lowrank_sdp_tpu.solver.common import init_factors as jax_init_factors
from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state as jax_rank_state
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_random_maxcut_problem)
from ltr_lowrank_sdp_tpu.testing import (
    random_multiblock_problem as jax_random_multiblock_problem)
from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
from ltr_lowrank_sdp_torch.ops.coneops import ConeOps
from ltr_lowrank_sdp_torch.parallel import dryrun
from ltr_lowrank_sdp_torch.parallel.launch import spawn
from ltr_lowrank_sdp_torch.parallel.mesh import Mesh, make_mesh
from ltr_lowrank_sdp_torch.parallel.meshops import (MeshConeOps,
                                                    _partition_by_id)
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                           matcomp_problem,
                                           random_maxcut_problem,
                                           random_multiblock_problem,
                                           random_sparse_cone)
from tests.test_coneops import random_cone

WORLD_SIZES = (2, 3)
OPS_CASES = [(kind, seed) for kind in ("sparse", "diag") for seed in (3, 5)]
N, M, R = 37, 23, 5
OPS = ("constr_vals", "apply_a", "apply_w", "constr_vals_pair",
       "cg_normal_matvec")
SOLVES = {
    "maxcut48": dict(kw={}, rtol=1e-9, atol=1e-10),
    "multiblock": dict(kw={"phase2_tol": 1e-6}, rtol=1e-8, atol=1e-9),
}


def _port_cone(kind, seed):
    """The port's twin of ``test_meshops.py``'s cone, its objective kind set
    as the JAX package classifies it, and the rng after the cone's draws."""
    rng = np.random.default_rng(seed)
    if kind == "diag":
        prob = random_sparse_cone(rng, N, M, nnz_per=1, diag_only=True)
    else:
        prob = random_sparse_cone(rng, N, M, force_kind="sparse")
    return prob.cones[0], rng


def _jax_cone(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "diag":
        return random_cone(rng, N, M, nnz_per=1, diag_only=True), rng
    return random_cone(rng, N, M, force_kind="sparse"), rng


def _inputs(rng):
    return {k: rng.normal(size=s) for k, s in
            (("U", (N, R)), ("V", (N, R)), ("w", (M,)), ("Y", (N, R)))}


def _apply(ops, name, x, t):
    U, V, w, Y = (t(x[k]) for k in ("U", "V", "w", "Y"))
    if name == "constr_vals":
        return [ops.constr_vals(U, V)]
    if name == "apply_a":
        return [ops.apply_a(w, Y)]
    if name == "apply_w":
        return [ops.apply_w(w, Y, obj_coef=0.7)]
    if name == "constr_vals_pair":
        return list(ops.constr_vals_pair(U, V))
    return [ops.cg_normal_matvec(V)(U)]


def _solve_problem(name):
    if name == "maxcut48":
        return random_maxcut_problem(48, avg_degree=5, seed=7)
    return random_multiblock_problem(dims=(16, 12), m=14, seed=11)


def _rank_cases(kind_c, starts):
    """Every case on one rank: returns plain numpy results."""
    mesh = make_mesh(device="cpu")
    out = {"ops": {}, "unsharded": {}, "solve": {}}
    for (kind, seed), kc in zip(OPS_CASES, kind_c):
        cone, rng = _port_cone(kind, seed)
        cone.kind_c = kc
        x = _inputs(rng)
        inner = ConeOps(cone, "cpu")
        mops = MeshConeOps(cone, inner, mesh)
        assert mops.sharded
        out["ops"][kind, seed] = {
            name: [a.numpy() for a in _apply(mops, name, x, torch.tensor)]
            for name in OPS}
        out["unsharded"][kind, seed] = {
            name: [a.numpy() for a in _apply(inner, name, x, torch.tensor)]
            for name in ("constr_vals", "apply_a")}
    # a rank that owns nothing: 2 constraints over up to 3 ranks
    cone = random_sparse_cone(np.random.default_rng(9), 10, 2,
                              force_kind="sparse").cones[0]
    inner = ConeOps(cone, "cpu")
    mops = MeshConeOps(cone, inner, mesh)
    rng = np.random.default_rng(10)
    U, V, Y = (torch.tensor(rng.normal(size=(10, 3))) for _ in range(3))
    w = torch.tensor(rng.normal(size=2))
    out["empty"] = {
        "cv_range": mops.cv_range, "mm_range": mops.mm_range,
        "got": [mops.constr_vals(U, V).numpy(), mops.apply_a(w, Y).numpy()],
        "want": [inner.constr_vals(U, V).numpy(),
                 inner.apply_a(w, Y).numpy()]}
    for name, (R0, v0) in starts.items():
        solver = Solver(_solve_problem(name),
                        SolverParams(dtype="float64", disable_oracle=True,
                                     **SOLVES[name]["kw"]), mesh=mesh)
        res = solver.solve(init_factors=R0, lanczos_start=v0)
        out["solve"][name] = {
            "status": res.status.value, "pobj": res.pobj, "dobj": res.dobj,
            "pinf_l1": res.pinf_l1, "gap": res.gap,
            "counts": (res.alm_outer_iters, res.alm_inner_iters,
                       res.admm_iters, res.cg_iters),
            "sharded": [c.sharded for c in solver.cones],
            "allreduce": sum(c.allreduce_calls for c in solver.cones)}
    return out


def _jax_starts(name, params):
    """The JAX solver's starting factors and Lanczos start vectors in the
    problem's own row order (the port's ``init_factors`` /
    ``lanczos_start``)."""
    if name == "maxcut48":
        jprob = jax_random_maxcut_problem(48, avg_degree=5, seed=7)
    else:
        jprob = jax_random_multiblock_problem(dims=(16, 12), m=14, seed=11)
    js = JaxSolver(jprob, params)
    ranks = jax_rank_state(jprob, params).ranks
    R0, _ = jax_init_factors(ranks, jprob.block_dims, 0,
                             jax.random.PRNGKey(params.seed), jnp.float64)
    key7 = jax.random.PRNGKey(7)
    R0 = [ops.permute_rows_out(np.asarray(r)) for ops, r in zip(js.cones, R0)]
    v0 = [ops.permute_rows_out(np.asarray(jax.random.normal(
        jax.random.fold_in(key7, i), (ops.n,), jnp.float64)))
        for i, ops in enumerate(js.cones)]
    return jprob, R0, v0


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(8, batch=1)


@pytest.fixture(scope="module")
def jax_side(mesh8):
    ops, kind_c = {}, []
    for kind, seed in OPS_CASES:
        cone, rng = _jax_cone(kind, seed)
        kind_c.append(cone.kind_c)
        x = _inputs(rng)
        mops = JaxMeshConeOps(cone, JaxConeOps(cone), mesh8, axis="constr")
        assert mops.sharded
        # each eager call of a shard_map body compiles it anew (about 1.3 s
        # here); under jit the nine calls per cone compile it twice
        mops._cv, mops._aw = jax.jit(mops._cv), jax.jit(mops._aw)
        ops[kind, seed] = {name: [np.asarray(a) for a in
                                  _apply(mops, name, x, jnp.asarray)]
                           for name in OPS}
    starts, solves = {}, {}
    for name, spec in SOLVES.items():
        params = JaxSolverParams(dtype="float64", disable_oracle=True,
                                 **spec["kw"])
        jprob, R0, v0 = _jax_starts(name, params)
        starts[name] = (R0, v0)
        solves[name] = JaxSolver(jprob, params, mesh=mesh8).solve()
    return {"ops": ops, "kind_c": kind_c, "starts": starts,
            "solves": solves}


@pytest.fixture(scope="module")
def port_side(jax_side):
    return {ws: spawn(_rank_cases, ws, (jax_side["kind_c"],
                                        jax_side["starts"]))
            for ws in WORLD_SIZES}


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("case", OPS_CASES, ids=lambda c: f"{c[0]}-s{c[1]}")
def test_meshops_match_jax_sharded(port_side, jax_side, case, ws):
    for name in OPS:
        for got, want in zip(port_side[ws][0]["ops"][case][name],
                             jax_side["ops"][case][name]):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("case", OPS_CASES, ids=lambda c: f"{c[0]}-s{c[1]}")
def test_meshops_bitwise_across_ranks_and_world_sizes(port_side, case):
    ref = port_side[WORLD_SIZES[0]][0]
    for name in ("constr_vals", "apply_a"):
        for got, want in zip(ref["ops"][case][name],
                             ref["unsharded"][case][name]):
            np.testing.assert_array_equal(got, want, err_msg=name)
    for ws in WORLD_SIZES:
        for rank_out in port_side[ws]:
            for name in OPS:
                for got, want in zip(rank_out["ops"][case][name],
                                     ref["ops"][case][name]):
                    np.testing.assert_array_equal(got, want, err_msg=name)


def test_rank_that_owns_nothing(port_side):
    outs = port_side[3]
    assert any(o["empty"]["cv_range"][0] == o["empty"]["cv_range"][1]
               for o in outs), [o["empty"]["cv_range"] for o in outs]
    for o in outs:
        for got, want in zip(o["empty"]["got"], o["empty"]["want"]):
            np.testing.assert_array_equal(got, want)


def test_partition_gives_empty_ranges_when_ids_are_few():
    ranges, owner = _partition_by_id(np.array([0, 0, 1, 1, 1]), 2, 3)
    assert ranges[0][0] == 0 and ranges[-1][1] == 2
    assert sum(hi > lo for lo, hi in ranges) <= 2
    assert all(ranges[o][0] <= i < ranges[o][1]
               for i, o in zip([0, 0, 1, 1, 1], owner))


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_sharded_solver_matches_jax_sharded(port_side, jax_side, name, ws):
    spec = SOLVES[name]
    jres = jax_side["solves"][name]
    got = port_side[ws][0]["solve"][name]
    assert SolverStatus(got["status"]) == SolverStatus(jres.status.value)
    assert got["status"] in ("primal_dual_optimal", "primal_optimal")
    np.testing.assert_allclose(got["pobj"], jres.pobj, rtol=spec["rtol"],
                               atol=spec["rtol"])
    np.testing.assert_allclose(got["pinf_l1"], jres.pinf_l1,
                               atol=spec["atol"])
    np.testing.assert_allclose(got["gap"], jres.gap, atol=spec["atol"])
    # every rank took the same path to the same numbers
    for rank_out in port_side[ws]:
        assert rank_out["solve"][name] == got
    if name == "maxcut48":
        assert got["sharded"] == [True] and got["allreduce"] > 0
    else:
        assert got["sharded"] == [False, False]


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_sharded_solver_takes_the_unsharded_path(port_side, jax_side, name):
    """The port's own unsharded solve from the same start: the same status
    and counts and pobj to 1e-9 at every world size (what the card run
    holds its sharded main paths to)."""
    R0, v0 = jax_side["starts"][name]
    res = Solver(_solve_problem(name),
                 SolverParams(dtype="float64", disable_oracle=True,
                              **SOLVES[name]["kw"]), device="cpu").solve(
        init_factors=R0, lanczos_start=v0)
    for ws in WORLD_SIZES:
        got = port_side[ws][0]["solve"][name]
        assert got["status"] == res.status.value
        assert got["counts"] == (res.alm_outer_iters, res.alm_inner_iters,
                                 res.admm_iters, res.cg_iters)
        assert got["pobj"] == pytest.approx(res.pobj, rel=1e-9, abs=1e-9)


def test_row_mode_and_a_foreign_device_raise():
    prob = random_maxcut_problem(20, avg_degree=4, seed=0)
    mesh = Mesh(shape={"batch": 1, "constr": 1},
                axis_names=("batch", "constr"), rank=0, coords=(0, 0),
                device=torch.device("cpu"), groups={})
    with pytest.raises(ValueError, match="no axis 'row'"):
        Solver(prob, mesh=mesh, mesh_axis="row")
    with pytest.raises(ValueError, match="not the mesh's"):
        Solver(prob, device="cuda:0", mesh=mesh)
    with pytest.raises(ValueError, match="no axis"):
        Solver(prob, mesh=mesh, mesh_axis="rows")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


# --------------------------------------------------------------------------- #
# world size 4


def _world4_cone():
    """A sparse cone of phase 5's family (matrix completion, chip_smoke's
    ``MC_ARGS`` at the tests' size) and seeded inputs of rank R."""
    prob = matcomp_problem(60, 60, 1, 1.0, seed=0)
    cone = prob.cones[0]
    assert cone.kind_a == "sparse"
    rng = np.random.default_rng(4)
    return cone, {k: rng.normal(size=s) for k, s in (
        ("U", (cone.n, R)), ("V", (cone.n, R)), ("w", (prob.m,)),
        ("Y", (cone.n, R)))}


def _world4_solve():
    """Phase 4's family and flags (``--phase1Tol 1e+1 --heuristicFactor
    100``) at the tests' size."""
    return (maxcut_problem_from_adjacency(delaunay_maxcut_adjacency(
        1024, seed=10)), SolverParams(phase1_tol=10.0, heuristic_factor=100.0))


def _world4_rank():
    mesh = make_mesh(device="cpu")
    cone, x = _world4_cone()
    mops = MeshConeOps(cone, ConeOps(cone, "cpu"), mesh)
    assert mops.sharded
    ops = {name: [a.numpy() for a in _apply(mops, name, x, torch.tensor)]
           for name in OPS}
    solve = dryrun.sharded_solve(*_world4_solve(), device="cpu")
    return {"ops": ops, "solve": {k: solve[k] for k in (
        "status", "pobj", "dobj", "pinf_l1", "gap", "alm_outer_iters",
        "alm_inner_iters", "admm_iters", "cg_iters", "allreduce_calls",
        "sharded")}}


@pytest.fixture(scope="module")
def world4():
    return {ws: spawn(_world4_rank, ws) for ws in (1, 4)}


@pytest.mark.parametrize("name", OPS)
def test_world4_operators_are_exact(world4, name):
    cone, x = _world4_cone()
    inner = ConeOps(cone, "cpu")
    want = [a.numpy() for a in _apply(inner, name, x, torch.tensor)]
    for rank_out in world4[4]:
        for got, ref, full in zip(rank_out["ops"][name],
                                  world4[1][0]["ops"][name], want):
            np.testing.assert_array_equal(got, ref, err_msg=name)
            if name in ("constr_vals", "apply_a"):
                np.testing.assert_array_equal(got, full, err_msg=name)
            else:
                np.testing.assert_allclose(got, full, rtol=1e-13,
                                           atol=1e-13, err_msg=name)


def test_world4_solve_takes_the_unsharded_path(world4):
    prob, params = _world4_solve()
    res = Solver(prob, params, device="cpu").solve()
    got = world4[4][0]["solve"]
    assert got["status"] == res.status.value == "primal_dual_optimal"
    assert (got["alm_outer_iters"], got["alm_inner_iters"],
            got["admm_iters"], got["cg_iters"]) == (
        res.alm_outer_iters, res.alm_inner_iters, res.admm_iters,
        res.cg_iters)
    assert got["pobj"] == pytest.approx(res.pobj, rel=1e-9, abs=1e-9)
    assert got["sharded"] == [True] and got["allreduce_calls"] > 0
    assert got == world4[1][0]["solve"]
    for rank_out in world4[4]:
        assert rank_out["solve"] == got


def test_spawn_refuses_more_nccl_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError,
                       match="4 NCCL ranks need 4 cards, this host has 2"):
        spawn(_world4_rank, 4, backend="nccl")


def test_make_mesh_refuses_more_nccl_ranks_than_cards(tmp_path,
                                                      monkeypatch):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(ValueError,
                           match="1 NCCL ranks need 1 cards, this host has "
                                 "0"):
            make_mesh()
    finally:
        dist.destroy_process_group()
