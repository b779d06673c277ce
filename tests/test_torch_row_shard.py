"""The row-sharded mesh mode (``mesh_axis="row"``, ``parallel/rowshard.py``)
on ``torch.distributed`` (gloo, CPU, one torch thread a rank) against the
port's unsharded solver and the JAX package's row mode
(``tests/test_meshops.py:115-140`` runs it on conftest's 8 virtual devices).

Each world size (1, 2, 3) is started once for the module
(``launch.spawn``); every rank runs every case and returns its arrays.

* The partition and its halo: contiguous blocks of the RCM order, uneven
  at n = 64 over 3 ranks, each rank's halo exactly the other ranks' rows its
  objective entries reference, the exchange's source of every halo row.
* Each row-sharded operator's rows bitwise the unsharded operator's rows:
  a ``diag_identity`` cone with a sparse objective (K1 on a shard with its
  halo, K2, K3, K4 on the rank's entries), one with a dense objective, and
  a general sparse cone (the gathered path, its constraint vector
  replicated).  The objective value is a partial: combined, it is the
  unsharded value's bits at world size 1 and within 1e-13 elsewhere.
* The rank-order combine: the same bits on every rank, the host's
  left-to-right sum of the partials, the partial itself at world size 1.
* The solve of ``random_maxcut_problem(64, 5, seed=3)`` from the JAX
  solver's starting factors: the unsharded solve's status and counts, pobj
  within 1e-9 relative and pinf, gap within 1e-10 of the port's unsharded
  solve and of JAX's row-mode solve; world size 1 the unsharded bits
  (asked: 1e-14); every rank bitwise rank 0.  The same for
  ``random_maxcut_problem(256, 5, seed=4)``, whose objective is sparse (the
  halo path).
* ``random_multiblock_problem((16, 12), 14, 11)`` at world size 2 (the
  gathered path of general cones): the unsharded status, pobj and gap
  within the unsharded solve's own spread under row relabelings (the same
  SDP summed in another order; 1.8e-6 in pobj and 2.4e-6 in the gap over
  relabelings 0-3, so the 1e-8 / 1e-9 of the constraint-sharded test,
  whose sums keep the unsharded order, cannot hold for any row split).
* World size 4 (what ``chip_smoke.py --multi-card`` runs over NCCL as
  ``[dn20-row4]``) on a Delaunay MaxCut of phase 4's family and flags at the
  tests' size: RCM blocks of 256 rows with their halos, and the solve with
  the unsharded solve's status and counts, pobj within 1e-9 relative,
  pinf and gap within 1e-10, every rank rank 0's.  Each world size adds its
  partials in its own partition, so its bits may part from world size 1's;
  at these sizes (and on phase 4's n = 2^14 file at world sizes 2 and 4)
  the counts do not.
* ``testing.optimum_bracket`` (the gate of a row-sharded world size whose
  counts part): its upper end is <C, X> of the rescaled factor, computed
  densely; the solver's Lanczos value is not below the exact least
  eigenvalue of the slack, so its bracket lies inside the exact one; the
  exact brackets of the solve and of a relabeled problem's solve overlap.
* ``python -m tests.test_torch_row_shard K W ...`` (from the repo's root)
  prints the solve of the Delaunay MaxCut of 2^K points (seed K, phase 4's
  flags) unsharded, row-sharded over each W gloo ranks, and unsharded on
  the graph relabeled (one random permutation): counts, pobj, dobj, the
  slack's least eigenvalue (ARPACK) beside the solver's, each solve's
  bracket and whether it overlaps the unsharded solve's (minutes a line at
  K = 16, 17).
* The dry run's axis 1b.
* ``-m cuda`` (no JAX: ``python -m pytest --noconftest
  tests/test_torch_row_shard.py -m cuda``): the row-sharded solve at world
  size 1 over NCCL against the unsharded solve (replayed graphs) on the
  card: the same status, counts and pobj bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.config import SolverParams
from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.ops.coneops import build_cone_ops_internal
from ltr_lowrank_sdp_torch.parallel import dryrun
from ltr_lowrank_sdp_torch.parallel.launch import spawn
from ltr_lowrank_sdp_torch.parallel.mesh import make_mesh
from ltr_lowrank_sdp_torch.parallel.rowshard import (RowConeOps,
                                                     RowPartition, RowReduce,
                                                     ShardLayout,
                                                     _sym_pattern)
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                           dense_objective_matrix,
                                           optimum_bracket,
                                           random_maxcut_problem,
                                           random_multiblock_problem,
                                           random_sparse_cone)

WORLD_SIZES = (1, 2, 3)
R = 5
ROW_OUT = ("apply_a", "apply_c", "apply_w", "cg")
M_OUT = ("cv", "cv_pair0", "cv_pair1")
MB_PARAMS = dict(dtype="float64", disable_oracle=True, phase2_tol=1e-6)
MC_PARAMS = dict(dtype="float64", disable_oracle=True)


def _op_problem(name):
    if name == "mc_sparse":
        return random_maxcut_problem(256, avg_degree=5, seed=4)
    if name == "mc_dense":
        return random_maxcut_problem(64, avg_degree=5, seed=3)
    return random_sparse_cone(np.random.default_rng(5), 37, 23,
                              force_kind="sparse")


OP_CASES = ("mc_sparse", "mc_dense", "general")


def _op_inputs(name, ops):
    rng = np.random.default_rng(11)
    U = torch.tensor(rng.normal(size=(ops.n, R)))
    V = torch.tensor(rng.normal(size=(ops.n, R)))
    w = torch.tensor(rng.normal(size=ops.m))
    return U, V, w


def _apply(ops, U, V, w):
    """Every operator of ``ops`` on (U, V, w)."""
    pair = ops.constr_vals_pair(U, V)
    return {"cv": ops.constr_vals(U, V), "cv_pair0": pair[0],
            "cv_pair1": pair[1], "apply_a": ops.apply_a(w, U),
            "apply_c": ops.apply_c(U), "apply_w": ops.apply_w(w, U, 0.7),
            "cg": ops.cg_normal_matvec(V)(U),
            "obj_uv": ops.obj_value(U, V), "obj_uu": ops.obj_value(U, U)}


def _unsharded_ops(name):
    prob = _op_problem(name)
    cones, _, _ = build_cone_ops_internal(prob, "cpu")
    return prob, cones[0]


def _rank_ops(mesh, name):
    prob, inner = _unsharded_ops(name)
    part = RowPartition.for_cone(prob.cones[0], inner, mesh.shape["row"])
    red = RowReduce(mesh, "row", m_sharded=inner.diag_identity)
    ops = RowConeOps(prob.cones[0], inner, part, red)
    U, V, w = _op_inputs(name, inner)
    own = ops.owned
    out = _apply(ops, U[own], V[own], w[own] if ops.local else w)
    (out["obj_uv"], out["obj_uu"]), _ = red.reduce([out["obj_uv"],
                                                    out["obj_uu"]])
    out = {k: v.numpy() for k, v in out.items()}
    out["owned"] = own.numpy()
    out["local"] = ops.local
    return out


def _rank(cases):
    """Every case on one rank of a fresh world."""
    mesh = make_mesh(axis_names=("batch", "row"), device="cpu")
    out = {"ops": {name: _rank_ops(mesh, name) for name in OP_CASES}}
    ws, s = mesh.shape["row"], mesh.rank
    red = RowReduce(mesh, "row")
    p = torch.tensor(np.random.default_rng(100 + s).normal(size=6))
    sums, norms = red.reduce([p[:4]], [p[4].abs(), p[5].abs()])
    out["combine"] = (p.numpy(), sums[0].numpy(),
                      np.array([float(x) for x in norms]))
    out["solve"] = {}
    for name, (prob, params, R0, v0) in cases.items():
        if name == "multiblock" and ws != 2:
            continue
        out["solve"][name] = dryrun.row_solve(
            prob, params, device="cpu", init_factors=R0, lanczos_start=v0,
            factors=True)
    return out


def _jax_starts(jprob, params):
    """The JAX solver's starting factors and Lanczos start vectors in the
    problem's own row order (``tests/test_torch_parallel.py``'s)."""
    import jax
    import jax.numpy as jnp

    from ltr_lowrank_sdp_tpu.solver.common import init_factors
    from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
    from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state

    js = JaxSolver(jprob, params)
    ranks = make_rank_state(jprob, params).ranks
    R0, _ = init_factors(ranks, jprob.block_dims, 0,
                         jax.random.PRNGKey(params.seed), jnp.float64)
    key7 = jax.random.PRNGKey(7)
    R0 = [ops.permute_rows_out(np.asarray(r)) for ops, r in zip(js.cones, R0)]
    v0 = [ops.permute_rows_out(np.asarray(jax.random.normal(
        jax.random.fold_in(key7, i), (ops.n,), jnp.float64)))
        for i, ops in enumerate(js.cones)]
    return R0, v0


@pytest.fixture(scope="module")
def jax_row():
    """JAX's starts and its row-mode solves of the two MaxCut cases."""
    import jax
    from jax.sharding import Mesh

    from ltr_lowrank_sdp_tpu.config import SolverParams as JaxParams
    from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
    from ltr_lowrank_sdp_tpu.testing import (
        random_maxcut_problem as jax_maxcut)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("row",))
    params = JaxParams(**MC_PARAMS)
    out = {}
    for name, n, seed in (("maxcut64", 64, 3), ("maxcut256", 256, 4)):
        jprob = jax_maxcut(n, avg_degree=5, seed=seed)
        R0, v0 = _jax_starts(jprob, params)
        res = JaxSolver(jprob, params, mesh=mesh, mesh_axis="row").solve()
        out[name] = (R0, v0, res)
    return out


def _cases(jax_row):
    mc = SolverParams(**MC_PARAMS)
    return {
        "maxcut64": (random_maxcut_problem(64, avg_degree=5, seed=3), mc,
                     *jax_row["maxcut64"][:2]),
        "maxcut256": (random_maxcut_problem(256, avg_degree=5, seed=4), mc,
                      *jax_row["maxcut256"][:2]),
        "multiblock": (random_multiblock_problem(dims=(16, 12), m=14,
                                                 seed=11),
                       SolverParams(**MB_PARAMS), None, None)}


@pytest.fixture(scope="module")
def port_side(jax_row):
    cases = _cases(jax_row)
    return {ws: spawn(_rank, ws, (cases,)) for ws in WORLD_SIZES}


@pytest.fixture(scope="module")
def unsharded(jax_row):
    out = {}
    for name, (prob, params, R0, v0) in _cases(jax_row).items():
        out[name] = Solver(prob, params, device="cpu").solve(
            init_factors=R0, lanczos_start=v0)
    return out


# --------------------------------------------------------------------------- #
# the partition


def test_partition_blocks_halo_and_exchange():
    prob = random_maxcut_problem(64, avg_degree=5, seed=3)
    cone = prob.cones[0]
    rows, cols = _sym_pattern(cone)
    for world in (1, 2, 3):
        part = RowPartition.build(64, world, rows, cols)
        sizes = part.sizes
        assert sum(sizes) == 64 and max(sizes) - min(sizes) <= 1
        if world == 3:
            assert sizes == [22, 21, 21]
        allrows = np.concatenate(part.owned)
        assert np.array_equal(np.sort(allrows), np.arange(64))
        for s in range(world):
            own = part.owned[s]
            assert np.array_equal(own, np.sort(own))
            assert np.array_equal(part.local[own], np.arange(own.size))
            assert (part.owner[own] == s).all()
            mine = np.isin(rows, own)
            want = np.setdiff1d(np.unique(cols[mine]), own)
            assert np.array_equal(part.halo[s], want)
            others = np.setdiff1d(np.arange(world), [s])
            exported = np.unique(np.concatenate(
                [part.halo[t] for t in others] + [np.zeros(0, np.int64)]))
            assert np.array_equal(part.export[s],
                                  exported[part.owner[exported] == s])
            # the exchange: rank t's export padded to the largest, stacked
            buf = np.full((world, max(part.max_export, 1)), -1)
            for t in range(world):
                buf[t, :part.export[t].size] = part.export[t]
            if part.halo[s].size:
                assert np.array_equal(buf.reshape(-1)[part.halo_src(s)],
                                      part.halo[s])
        if world == 1:
            assert part.max_export == 0 and part.halo[0].size == 0


def test_partition_follows_the_rcm_order_of_k1():
    prob = random_maxcut_problem(256, avg_degree=5, seed=4)
    cones, _, _ = build_cone_ops_internal(prob, "cpu")
    order = cones[0].c_csr.order.numpy()
    part = RowPartition.for_cone(prob.cones[0], cones[0], 3)
    blocks = np.array_split(order, 3)
    for s in range(3):
        assert np.array_equal(part.owned[s], np.sort(blocks[s]))
    # a dense objective or a general cone: blocks of the problem's order
    prob = random_maxcut_problem(64, avg_degree=5, seed=3)
    cones, _, _ = build_cone_ops_internal(prob, "cpu")
    part = RowPartition.for_cone(prob.cones[0], cones[0], 3)
    assert np.array_equal(part.owned[0], np.arange(22))


def test_shard_layout_without_a_process_group():
    """One rank's K1 and K4 layout in one process, its halo rows taken
    from the whole factor: the rows and the partial the ranks compute."""
    prob = random_maxcut_problem(256, avg_degree=5, seed=4)
    cones, _, _ = build_cone_ops_internal(prob, "cpu")
    inner = cones[0]
    part = RowPartition.for_cone(prob.cones[0], inner, 2)
    U, V, w = _op_inputs("mc_sparse", inner)
    full = K.spmm_sym_csr(inner.c_csr, U, 0.7, d=inner.diag_val, w=w)
    obj = 0.0
    for s in range(2):
        lay = ShardLayout.build(prob.cones[0], inner, part, s)
        own = lay.owned
        ue = lay.extend(U[own], lay.halo_from_full(U, part))
        ve = lay.extend(V[own], lay.halo_from_full(V, part))
        got = K.spmm_sym_csr(lay.csr, ue, 0.7, d=lay.diag_val, w=w[own])
        assert torch.equal(got, full[own])
        obj += float(K.sym_contract_sum(lay.k4_rows, lay.k4_cols,
                                        lay.k4_coef, ue, ve))
    want = float(K.sym_contract_sum(inner.c_rows, inner.c_cols,
                                    inner.c_double_coef, U, V))
    assert obj == pytest.approx(want, rel=1e-13)


# --------------------------------------------------------------------------- #
# the operators and the combine on every rank


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("name", OP_CASES)
def test_row_operators_give_the_unsharded_rows(port_side, ws, name):
    prob, inner = _unsharded_ops(name)
    U, V, w = _op_inputs(name, inner)
    want = {k: v.numpy() for k, v in _apply(inner, U, V, w).items()}
    ranks = port_side[ws]
    assert sorted(np.concatenate([r["ops"][name]["owned"]
                                  for r in ranks])) == list(range(inner.n))
    for r in ranks:
        got = r["ops"][name]
        own = got["owned"]
        assert got["local"] == (name != "general")
        for k in ROW_OUT:
            assert np.array_equal(got[k], want[k][own]), k
        for k in M_OUT:
            assert np.array_equal(got[k], want[k][own] if got["local"]
                                  else want[k]), k
        for k in ("obj_uv", "obj_uu"):
            assert got[k] == ranks[0]["ops"][name][k]
            if ws == 1:
                assert got[k] == want[k], k
            else:
                assert got[k] == pytest.approx(want[k], rel=1e-13), k


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_rank_order_combine(port_side, ws):
    ranks = port_side[ws]
    parts = [r["combine"][0] for r in ranks]
    want = parts[0][:4].copy()
    sq = parts[0][4:] ** 2
    for p in parts[1:]:
        want = want + p[:4]
        sq = sq + p[4:] ** 2
    want_n = np.abs(parts[0][4:]) if ws == 1 else np.sqrt(sq)
    for r in ranks:
        assert np.array_equal(r["combine"][1], want)
        assert np.array_equal(r["combine"][2], want_n)
    if ws == 1:
        assert np.array_equal(ranks[0]["combine"][1], parts[0][:4])


# --------------------------------------------------------------------------- #
# the solves


def _counts(res):
    return (res.alm_outer_iters, res.alm_inner_iters, res.admm_iters,
            res.cg_iters)


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("name", ["maxcut64", "maxcut256"])
def test_row_solve_matches_unsharded_and_jax(port_side, unsharded, jax_row,
                                             ws, name):
    res0 = unsharded[name]
    jres = jax_row[name][2]
    assert res0.errors_ok
    ranks = port_side[ws]
    got = ranks[0]["solve"][name]
    assert got["status"] == res0.status.value == jres.status.value
    assert got["counts"] == _counts(res0)
    assert got["final_ranks"] == res0.final_ranks
    for ref in (res0, jres):
        np.testing.assert_allclose(got["pobj"], ref.pobj, rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(got["pinf_l1"], ref.pinf_l1, atol=1e-10)
        np.testing.assert_allclose(got["gap"], ref.gap, atol=1e-10)
    if ws == 1:
        for f, ref in (("pobj", res0.pobj), ("pinf_l1", res0.pinf_l1),
                       ("gap", res0.gap), ("dinf_l1", res0.dinf_l1)):
            assert abs(got[f] - ref) <= 1e-14 * max(1.0, abs(ref)), f
        assert np.array_equal(got["U"][0], res0.U[0])
    for r in ranks[1:]:
        other = r["solve"][name]
        for f in ("status", "pobj", "dobj", "pinf_l1", "gap", "dinf_l1",
                  "counts", "final_ranks"):
            assert other[f] == got[f], f
        assert np.array_equal(other["U"][0], got["U"][0])
        assert np.array_equal(other["dual"], got["dual"])
    assert got["rows"][0] == len(np.array_split(np.arange(
        int(res0.U[0].shape[0])), ws)[0])


def _relabeled(prob, seed):
    """``prob`` with each cone's rows renamed by a seeded permutation."""
    rng = np.random.default_rng(seed)

    def ren(c):
        perm = rng.permutation(c.n)

        def pair(r, k):
            a, b = perm[np.asarray(r)], perm[np.asarray(k)]
            return (np.minimum(a, b).astype(np.asarray(r).dtype),
                    np.maximum(a, b).astype(np.asarray(k).dtype))

        c_rows, c_cols = pair(c.c_rows, c.c_cols)
        a_rows, a_cols = pair(c.a_rows, c.a_cols)
        return dataclasses.replace(c, c_rows=c_rows, c_cols=c_cols,
                                   a_rows=a_rows, a_cols=a_cols)

    return dataclasses.replace(prob, cones=[ren(c) for c in prob.cones])


def test_row_solve_of_general_cones(port_side, unsharded):
    res0 = unsharded["multiblock"]
    assert res0.errors_ok
    prob = random_multiblock_problem(dims=(16, 12), m=14, seed=11)
    assert all(c.kind_a != "diag" for c in prob.cones)
    params = SolverParams(**MB_PARAMS)
    spread = [res0] + [Solver(_relabeled(prob, k), params,
                              device="cpu").solve() for k in (1, 2, 3)]
    d_pobj = max(r.pobj for r in spread) - min(r.pobj for r in spread)
    d_gap = max(r.gap for r in spread) - min(r.gap for r in spread)
    ranks = port_side[2]
    got = ranks[0]["solve"]["multiblock"]
    assert got["status"] == res0.status.value
    assert abs(got["pobj"] - res0.pobj) <= d_pobj
    assert abs(got["gap"] - res0.gap) <= d_gap
    assert got["pobj"] == ranks[1]["solve"]["multiblock"]["pobj"]
    assert got["collectives"] > 0


def _delaunay():
    """Phase 4's family and flags (``--phase1Tol 1e+1 --heuristicFactor
    100``) at the tests' size."""
    return (maxcut_problem_from_adjacency(delaunay_maxcut_adjacency(
        1024, seed=10)), SolverParams(phase1_tol=10.0, heuristic_factor=100.0))


def test_partition_of_a_delaunay_maxcut_at_world_4():
    prob, _ = _delaunay()
    inner = build_cone_ops_internal(prob, "cpu")[0][0]
    part = RowPartition.for_cone(prob.cones[0], inner, 4)
    assert part.sizes == [256] * 4
    assert all(h.size > 0 for h in part.halo)
    order = inner.c_csr.order.numpy()
    for s, own in enumerate(part.owned):
        np.testing.assert_array_equal(own, np.sort(order[256 * s:
                                                         256 * (s + 1)]))


def test_row_solve_at_world_4():
    prob, params = _delaunay()
    res0 = Solver(prob, params, device="cpu").solve()
    ranks = spawn(dryrun.row_solve, 4, (prob, params, "cpu"))
    got = ranks[0]
    assert got["status"] == res0.status.value == "primal_dual_optimal"
    assert got["counts"] == _counts(res0)
    np.testing.assert_allclose(got["pobj"], res0.pobj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["pinf_l1"], res0.pinf_l1, atol=1e-10)
    np.testing.assert_allclose(got["gap"], res0.gap, atol=1e-10)
    assert got["rows"] == [256] and got["collectives"] > 0
    for r in ranks[1:]:
        for f in ("status", "pobj", "dobj", "pinf_l1", "gap", "dinf_l1",
                  "counts", "final_ranks", "collectives"):
            assert r[f] == got[f], f


def _slack(prob, dual, obj_scale):
    """S = C - A^T(dual / obj_scale) of a MaxCut problem, scipy CSR."""
    import scipy.sparse as sp

    cone = prob.cones[0]
    C = sp.coo_matrix((cone.c_vals, (cone.c_rows, cone.c_cols)),
                      shape=(cone.n, cone.n)).tocsr()
    y = np.zeros(cone.n)
    np.add.at(y, cone.diag_idx, cone.diag_val
              * np.asarray(dual, np.float64)[cone.diag_cid] / obj_scale)
    return (C + sp.triu(C, 1).T - sp.diags(y)).tocsr()


def _relabeled_graph(adj, seed):
    """The MaxCut problem of ``adj`` with its vertices permuted."""
    perm = np.random.default_rng(seed).permutation(adj.shape[0])
    return maxcut_problem_from_adjacency(adj[perm][:, perm].tocsc())


def _bracketed(prob, params):
    """The unsharded solve of ``prob``, the exact least eigenvalue of its
    slack and its exact bracket."""
    res = Solver(prob, params, device="cpu").solve()
    lam = np.linalg.eigvalsh(_slack(prob, res.dual, res.obj_scale)
                             .toarray())[0]
    return res, lam, optimum_bracket(prob, res.U, res.V, res.dual,
                                     res.obj_scale, lam)


def test_optimum_bracket_is_certified():
    prob, params = _delaunay()
    res, lam, (lo, hi) = _bracketed(prob, params)
    assert res.status.value == "primal_dual_optimal"
    lam_solver = -res.dinf_l1 * (1.0 + prob.c_nrm1)
    assert lam < 0 and lam <= lam_solver <= 0
    lo_s, hi_s = optimum_bracket(prob, res.U, res.V, res.dual,
                                 res.obj_scale, lam_solver)
    assert hi_s == hi and lo <= lo_s <= hi
    R = 0.5 * (res.U[0] + res.V[0])
    X = R @ R.T
    d = 1.0 / np.sqrt(np.diag(X))
    X = X * d[:, None] * d[None, :]
    assert np.sum(dense_objective_matrix(prob.cones[0]) * X) == \
        pytest.approx(hi, rel=1e-12)
    assert lo <= hi


@pytest.mark.parametrize("seed", [0, 1])
def test_optimum_brackets_of_a_relabeled_solve_overlap(seed):
    prob, params = _delaunay()
    _, _, (lo, hi) = _bracketed(prob, params)
    adj = delaunay_maxcut_adjacency(1024, seed=10)
    res, _, (lo_r, hi_r) = _bracketed(_relabeled_graph(adj, seed), params)
    assert res.status.value == "primal_dual_optimal"
    assert max(lo, lo_r) <= min(hi, hi_r)


def test_dryrun_runs_axis_1b():
    line = dryrun.dryrun(3, device="cpu")
    assert ("row-sharded solve (n = 48; rank 0: 16 owned, 0 halo, 0 "
            "exported; rank 1: 16 owned, 0 halo, 0 exported; rank 2: 16 "
            "owned, 0 halo, 0 exported) primal_dual_optimal") in line


# --------------------------------------------------------------------------- #
# the card (no JAX)


@pytest.mark.cuda
def test_row_solve_over_nccl_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL has no CPU mode)")
    K.build_kernels()
    prob = random_maxcut_problem(4096, avg_degree=5, seed=3)
    params = SolverParams(**MC_PARAMS)
    res0 = Solver(prob, params).solve()
    assert res0.graph_replays > 0
    (got,) = spawn(dryrun.row_solve, 1, (prob, params), backend="nccl")
    assert got["status"] == res0.status.value
    assert got["counts"] == _counts(res0)
    assert got["pobj"] == res0.pobj and got["gap"] == res0.gap
    assert got["kernels"]["spmm_sym_csr"][0] > 0
    assert got["kernels"]["spmm_sym_csr"][1] == 0


def _parting(k: int, worlds) -> None:
    """One line a solve of the Delaunay MaxCut of 2^k points: unsharded,
    row-sharded over each world size of ``worlds`` (gloo, CPU), unsharded
    on the graph relabeled; each against the unsharded solve."""
    import time

    from scipy.sparse.linalg import eigsh

    torch.set_num_threads(1)
    adj = delaunay_maxcut_adjacency(2 ** k, seed=k)
    prob = maxcut_problem_from_adjacency(adj)
    params = SolverParams(phase1_tol=10.0, heuristic_factor=100.0)

    def report(tag, p, o, ref):
        lam = eigsh(_slack(p, o["dual"], o["obj_scale"]), k=1, which="SA",
                    tol=1e-10, ncv=64)[0][0]
        lam_solver = -o["dinf_l1"] * (1.0 + p.c_nrm1)
        lo, hi = optimum_bracket(p, o["U"], o["V"], o["dual"],
                                 o["obj_scale"], lam)
        lo_s = optimum_bracket(p, o["U"], o["V"], o["dual"], o["obj_scale"],
                               lam_solver)[0]
        line = (f"n=2^{k} {tag}: {o['status']} {o['counts']} pobj "
                f"{o['pobj']!r} dobj {o['dobj']!r} pinf {o['pinf_l1']:.3e} "
                f"gap {o['gap']:.3e}; least eigenvalue of the slack {lam:.6e}"
                f" (the solver's {lam_solver:.6e}); bracket [{lo:.6f}, "
                f"{hi:.6f}] ([{lo_s:.6f}, {hi:.6f}] with the solver's)")
        if ref is not None:
            diff = abs(o["pobj"] - ref["pobj"])
            gaps = sum(abs(x["pobj"] - x["dobj"]) for x in (o, ref))
            top = min(hi, ref["hi"])
            line += (f"; |pobj - unsharded| {diff:.6g} "
                     f"({diff / abs(ref['pobj']):.2e}), the two |pobj - dobj|"
                     f" {gaps:.6g}, brackets overlap "
                     f"{max(lo, ref['lo']) <= top} (with the solver's "
                     f"{max(lo_s, ref['lo_s']) <= top})")
        print(f"{line} ({time.perf_counter() - t:.1f} s)", flush=True)
        return {"pobj": o["pobj"], "dobj": o["dobj"], "lo": lo, "hi": hi,
                "lo_s": lo_s}

    def unsharded(p):
        res = Solver(p, params, device="cpu").solve()
        return {"status": res.status.value, "counts": _counts(res),
                "pobj": res.pobj, "dobj": res.dobj, "pinf_l1": res.pinf_l1,
                "gap": res.gap, "dinf_l1": res.dinf_l1, "U": res.U,
                "V": res.V, "dual": res.dual, "obj_scale": res.obj_scale}

    t = time.perf_counter()
    ref = report("unsharded", prob, unsharded(prob), None)
    for ws in worlds:
        t = time.perf_counter()
        ranks = spawn(dryrun.row_solve, ws, (prob, params, "cpu", None, None,
                                             True))
        assert all(r["pobj"] == ranks[0]["pobj"]
                   and r["counts"] == ranks[0]["counts"] for r in ranks)
        report(f"world size {ws}", prob, ranks[0], ref)
    t = time.perf_counter()
    relabeled = _relabeled_graph(adj, 0)
    report("relabeled, unsharded", relabeled, unsharded(relabeled), ref)


if __name__ == "__main__":
    import sys

    _parting(int(sys.argv[1]), [int(w) for w in sys.argv[2:]])
