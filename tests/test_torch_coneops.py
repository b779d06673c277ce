"""Parity of the PyTorch port's conic operators with the JAX package's
``ConeOps`` (``ltr_lowrank_sdp_tpu/ops/coneops.py``): the MaxCut family
(``diag_identity``), the general path (sparse constraints, a diag cone
that is not one constraint per row, matrix completion, a cone with no
constraint entry), and, in the last section, dense objectives (``c_dense``
and ``torch.matmul``), several cones sharing one constraint space, and the
LP cone (``LPOps``), on ``random_multiblock_problem()``, a small Lovasz theta
problem and the small multi-block + LP instance.

Both packages build the same ``SDPProblem`` from a seed; inputs are numpy
arrays in the problem's original row and constraint order.  The JAX
operators work in a relabeled internal order (``row_order`` for vertices,
``constr_order`` for constraints), the port only relabels the constraints
of a ``diag_identity`` cone, so every output is mapped back to the original
order before comparing.  On the CPU every operator runs through its
kernel's plain PyTorch version.  The general path is also held against a
dense numpy evaluation that shares no code with either package's operators.

Tolerance: relative 1e-12 in the 2-norm (float64; the two sides sum in
different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.io.sdpa import SDPABlock as JaxSDPABlock
from ltr_lowrank_sdp_tpu.io.sdpa import SDPAData as JaxSDPAData
from ltr_lowrank_sdp_tpu.ops.coneops import (
    all_constr_vals as jax_all_constr_vals)
from ltr_lowrank_sdp_tpu.ops.coneops import (
    all_obj_value as jax_all_obj_value)
from ltr_lowrank_sdp_tpu.ops.coneops import (
    build_cone_ops as jax_build_cone_ops)
from ltr_lowrank_sdp_tpu.ops.coneops import (
    build_cone_ops_internal as jax_build_cone_ops_internal)
from ltr_lowrank_sdp_tpu.problem import canonicalize as jax_canonicalize
from ltr_lowrank_sdp_tpu.problem import initial_ranks as jax_initial_ranks
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_random_maxcut_problem)
from ltr_lowrank_sdp_tpu.testing import (
    random_multiblock_problem as jax_random_multiblock_problem)
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.ops.coneops import (
    ConeOps, LPOps, all_constr_vals, all_obj_value, build_cone_ops,
    build_cone_ops_internal)
from ltr_lowrank_sdp_torch.problem import canonicalize, initial_ranks
from ltr_lowrank_sdp_torch.testing import (
    dense_constraint_matrices, dense_objective_matrix, matcomp_problem,
    multiblock_lp_problem, multiblock_lp_sdpa, random_maxcut_problem,
    random_multiblock_problem, random_sparse_cone, theta_sdpa)

RTOL = 1e-12
RANK = 7
METHODS = ["constr_vals", "constr_vals_pair", "cg_normal_matvec", "obj_value",
           "obj_value_same", "apply_c", "apply_a", "apply_w"]


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


class _Pair:
    """One problem built by both packages, plus seeded inputs."""

    def __init__(self, n, seed):
        self.jp = jax_random_maxcut_problem(n, avg_degree=4, seed=seed)
        self.tp = random_maxcut_problem(n, avg_degree=4, seed=seed)
        jc, _, self.jorder = jax_build_cone_ops_internal(self.jp, jnp.float64)
        tc, _, self.torder = build_cone_ops_internal(self.tp, "cpu")
        self.j, self.t = jc[0], tc[0]
        rng = np.random.default_rng(seed + 100)
        self.U = rng.standard_normal((n, RANK))
        self.V = rng.standard_normal((n, RANK))
        self.w = rng.standard_normal(n)
        self.m = n

    # original order -> each side's internal order
    def j_rows(self, X):
        return jnp.asarray(self.j.permute_rows_in(X))

    def j_constr(self, w):
        return jnp.asarray(w[self.jorder])

    def t_constr(self, w):
        return torch.tensor(w[self.torder])

    # each side's internal order -> original order
    def j_rows_out(self, X):
        return self.j.permute_rows_out(np.asarray(X))

    def constr_out(self, x, order):
        out = np.empty(self.m)
        out[order] = np.asarray(x)
        return out


@pytest.fixture(scope="module", params=[(120, 3), (300, 8)],
                ids=["n120", "n300"])
def pair(request):
    return _Pair(*request.param)


def test_problem_arrays_identical(pair):
    jc, tc = pair.jp.cones[0], pair.tp.cones[0]
    for name in ("c_rows", "c_cols", "c_vals", "a_rows", "a_cols", "a_vals",
                 "a_cid", "diag_idx", "diag_val", "diag_cid"):
        np.testing.assert_array_equal(getattr(jc, name), getattr(tc, name))
    assert (jc.kind_a, jc.kind_c) == (tc.kind_a, tc.kind_c) == ("diag",
                                                                "sparse")
    assert pair.t.diag_identity and pair.j.diag_identity
    for name in ("c_nrm1", "c_nrm2", "c_nrminf", "b_nrm1", "b_nrm2",
                 "b_nrminf"):
        assert getattr(pair.jp, name) == getattr(pair.tp, name)


@pytest.mark.parametrize("method", METHODS)
def test_operator_matches_jax(pair, method):
    U, V, w = pair.U, pair.V, pair.w
    Uj, Vj = pair.j_rows(U), pair.j_rows(V)
    Ut, Vt = torch.tensor(U), torch.tensor(V)
    if method == "constr_vals":
        want = pair.constr_out(pair.j.constr_vals(Uj, Vj), pair.jorder)
        got = pair.constr_out(pair.t.constr_vals(Ut, Vt), pair.torder)
        assert _rel(got, want) <= RTOL
    elif method == "constr_vals_pair":
        j1, j2 = pair.j.constr_vals_pair(Uj, Vj)
        t1, t2 = pair.t.constr_vals_pair(Ut, Vt)
        assert _rel(pair.constr_out(t1, pair.torder),
                    pair.constr_out(j1, pair.jorder)) <= RTOL
        assert _rel(pair.constr_out(t2, pair.torder),
                    pair.constr_out(j2, pair.jorder)) <= RTOL
    elif method == "cg_normal_matvec":
        want = pair.j_rows_out(pair.j.cg_normal_matvec(Vj)(Uj))
        got = pair.t.cg_normal_matvec(Vt)(Ut).numpy()
        assert _rel(got, want) <= RTOL
    elif method == "obj_value":
        want = float(pair.j.obj_value(Uj, Vj))
        got = float(pair.t.obj_value(Ut, Vt))
        assert abs(got - want) <= RTOL * abs(want)
    elif method == "obj_value_same":
        # U is V takes the half-gather shortcut on both sides
        want = float(pair.j.obj_value(Uj, Uj))
        got = float(pair.t.obj_value(Ut, Ut))
        assert abs(got - want) <= RTOL * abs(want)
    elif method == "apply_c":
        want = pair.j_rows_out(pair.j.apply_c(Uj))
        got = pair.t.apply_c(Ut).numpy()
        assert _rel(got, want) <= RTOL
    elif method == "apply_a":
        want = pair.j_rows_out(pair.j.apply_a(pair.j_constr(w), Uj))
        got = pair.t.apply_a(pair.t_constr(w), Ut).numpy()
        assert _rel(got, want) <= RTOL
    elif method == "apply_w":
        for coef in (1.0, 2.5):
            want = pair.j_rows_out(pair.j.apply_w(
                pair.j_constr(w), Uj, obj_coef=coef, include_obj=True))
            got = pair.t.apply_w(pair.t_constr(w), Ut, obj_coef=coef).numpy()
            assert _rel(got, want) <= RTOL
        want = pair.j_rows_out(pair.j.apply_w(pair.j_constr(w), Uj,
                                              include_obj=False))
        got = pair.t.apply_w(pair.t_constr(w), Ut, include_obj=False).numpy()
        assert _rel(got, want) <= RTOL
    else:
        raise AssertionError(method)


def test_cpu_operators_take_the_plain_path(pair):
    K.reset_counts()
    Ut = torch.tensor(pair.U)
    pair.t.apply_w(pair.t_constr(pair.w), Ut)
    pair.t.constr_vals_pair(Ut, Ut)
    pair.t.cg_normal_matvec(Ut)(Ut)
    pair.t.obj_value(Ut, Ut)
    counts = K.counts()
    assert all(launches == 0 for launches, _ in counts.values())
    maxcut = {"spmm_sym_csr", "diag_rowdot", "diag_normal_matvec",
              "sym_contract_sum"}
    assert all(plain == (1 if name in maxcut else 0)
               for name, (_, plain) in counts.items()), counts


def test_unported_cones_raise():
    """Multi-block problems, dense cones, dense objectives and float32
    compute all build now (each raised before its slice); what raises is a
    compute dtype other than float32 or float64."""
    from ltr_lowrank_sdp_tpu.testing import random_multiblock_problem

    prob = random_multiblock_problem()
    cones, lp, order = build_cone_ops_internal(prob, "cpu")
    assert len(cones) == 3 and lp is None and order is None
    cone = random_sparse_cone(np.random.default_rng(0), 12, 7).cones[0]
    assert (cone.kind_a, cone.kind_c) == ("dense", "dense")
    ops = ConeOps(cone, "cpu")
    assert ops.c_dense is not None and ops.c_csr is None
    assert ops.a_seg is not None and ops.a_csr is not None
    cone.kind_a = "sparse"
    assert ConeOps(cone, "cpu").c_dense is not None
    cone.kind_c = "sparse"
    assert ConeOps(cone, "cpu").c_dense is None
    # float32 operators carry float32 values in every layout
    ops32 = ConeOps(cone, "cpu", dtype=torch.float32)
    assert ops32.c_dense is None and ops32.c_csr.vals.dtype == torch.float32
    assert ops32.a_seg.coef.dtype == ops32.a_csr.vals.dtype == torch.float32
    lp32 = LPOps(multiblock_lp_problem((6, 5), 8, 10, 0).lp, "cpu",
                 dtype=torch.float32)
    assert lp32.entries.row_val.dtype == lp32.c.dtype == torch.float32
    with pytest.raises(TypeError, match="float32 or float64"):
        ConeOps(cone, "cpu", dtype=torch.float16)


# --------------------------------------------------------------------------- #
# the general path: sparse constraints and non-identity diag cones
# --------------------------------------------------------------------------- #


def _jax_twin(prob, like):
    """The same raw entries through the JAX package's own ``SDPABlock`` and
    ``canonicalize``, with the cone kinds forced as on the port's side."""
    c = prob.cones[0]
    blk = JaxSDPABlock(dim=c.n, c_rows=c.c_rows, c_cols=c.c_cols,
                       c_vals=c.c_vals, a_rows=c.a_rows, a_cols=c.a_cols,
                       a_vals=c.a_vals, a_cid=c.a_cid)
    jp = jax_canonicalize(JaxSDPAData(n_constrs=prob.m, blocks=[blk],
                                      b=prob.b))
    jp.cones[0].kind_a, jp.cones[0].kind_c = like
    return jp


def _general_problem(kind):
    rng = np.random.default_rng(42)
    if kind == "sparse":      # several entries per constraint, duplicates
        return random_sparse_cone(rng, 40, 25, nnz_per=4, force_kind="sparse")
    if kind == "diag":        # 45 one-entry diagonal constraints on 30 rows
        prob = random_sparse_cone(rng, 30, 45, nnz_per=1, diag_only=True)
        prob.cones[0].kind_c = "sparse"
        return prob
    if kind == "matcomp":     # every constraint one off-diagonal entry
        return matcomp_problem(120, 120, rank=2, sample_factor=0.5, seed=0)
    if kind == "empty":       # no constraint entry in the cone
        prob = random_sparse_cone(rng, 30, 5, nnz_per=0, force_kind="sparse")
        assert prob.cones[0].a_rows.size == 0
        return prob
    raise AssertionError(kind)


class _GeneralPair(_Pair):
    def __init__(self, kind):
        self.kind = kind
        self.tp = _general_problem(kind)
        cone = self.tp.cones[0]
        self.cone = cone
        self.jp = _jax_twin(self.tp, (cone.kind_a, cone.kind_c))
        jc, _, self.jorder = jax_build_cone_ops_internal(self.jp, jnp.float64)
        tc, _, self.torder = build_cone_ops_internal(self.tp, "cpu")
        self.j, self.t = jc[0], tc[0]
        assert self.jorder is None and self.torder is None
        self.jorder = self.torder = np.arange(cone.m)
        rng = np.random.default_rng(7)
        n = cone.n
        self.U = rng.standard_normal((n, RANK))
        self.V = rng.standard_normal((n, RANK))
        self.w = rng.standard_normal(cone.m)
        self.m = cone.m

    def dense(self):
        """(X -> A(X), S(w)) evaluated densely from the problem's own COO
        entries, with numpy scatter-adds only."""
        c = self.cone
        rows, cols, vals, cid = c.a_rows, c.a_cols, c.a_vals, c.a_cid
        mult = np.where(rows != cols, 2.0, 1.0)

        def constr(X):
            out = np.zeros(c.m)
            np.add.at(out, cid, mult * vals * X[rows, cols])
            return out

        def adjoint(w):
            S = np.zeros((c.n, c.n))
            np.add.at(S, (rows, cols), w[cid] * vals)
            off = rows != cols
            np.add.at(S, (cols[off], rows[off]), (w[cid] * vals)[off])
            return S

        return constr, adjoint, dense_objective_matrix(c)


GENERAL = ["sparse", "diag", "matcomp", "empty"]


def _match(got, want):
    """Relative RTOL in the 2-norm; an all-zero reference (the cone with no
    constraint entry) must be met exactly."""
    if not np.any(want):
        assert not np.any(np.asarray(got))
    else:
        assert _rel(got, want) <= RTOL


@pytest.fixture(scope="module", params=GENERAL)
def gpair(request):
    return _GeneralPair(request.param)


def test_general_cone_kinds(gpair):
    kinds = {"sparse": ("sparse", False), "diag": ("diag", False),
             "matcomp": ("sparse", False), "empty": ("sparse", False)}
    assert (gpair.t.kind_a, gpair.t.diag_identity) == kinds[gpair.kind]
    assert gpair.t.kind_c == "sparse" and gpair.t.constr_order is None
    assert not gpair.j.diag_identity
    if gpair.kind == "diag":
        assert gpair.cone.m != gpair.cone.n
    if gpair.kind == "sparse":
        # the hard cases are present: several entries of one constraint in
        # one row, and a diagonal entry
        c = gpair.cone
        per_row = {}
        for r, k in zip(c.a_rows.tolist(), c.a_cid.tolist()):
            per_row[(r, k)] = per_row.get((r, k), 0) + 1
        assert max(per_row.values()) > 1
        assert np.any(c.a_rows == c.a_cols)
    for rank in (1, RANK):
        assert gpair.t.constr_flops(rank) == gpair.j.constr_flops(rank)
        assert gpair.t.apply_flops(rank) == gpair.j.apply_flops(rank)


@pytest.mark.parametrize("method", METHODS + ["apply_w_rank1"])
def test_general_operator_matches_jax(gpair, method):
    if method == "apply_w_rank1":
        # the Lanczos matvec applies the slack to one column
        U, w = gpair.U[:, :1], gpair.w
        want = gpair.j_rows_out(gpair.j.apply_w(
            gpair.j_constr(w), gpair.j_rows(U), obj_coef=0.5,
            include_obj=True))
        got = gpair.t.apply_w(torch.tensor(w), torch.tensor(U),
                              obj_coef=0.5).numpy()
        assert got.shape == (gpair.cone.n, 1)
        assert _rel(got, want) <= RTOL
    else:
        test_operator_matches_jax(gpair, method)


@pytest.mark.parametrize("method", ["constr_vals", "constr_vals_same",
                                    "constr_vals_pair", "cg_normal_matvec",
                                    "obj_value", "apply_c", "apply_a",
                                    "apply_w", "apply_w_no_obj"])
def test_general_operator_matches_dense_reference(gpair, method):
    constr, adjoint, C = gpair.dense()
    U, V, w = gpair.U, gpair.V, gpair.w
    Ut, Vt, wt = torch.tensor(U), torch.tensor(V), torch.tensor(w)
    sym = 0.5 * (U @ V.T + V @ U.T)
    ops = gpair.t
    if method == "constr_vals":
        _match(ops.constr_vals(Ut, Vt), constr(sym))
    elif method == "constr_vals_same":
        got = ops.constr_vals(Ut, Ut)
        assert got.shape == (gpair.cone.m,)
        _match(got, constr(U @ U.T))
    elif method == "constr_vals_pair":
        o1, o2 = ops.constr_vals_pair(Ut, Vt)
        _match(o1, constr(2.0 * sym))
        _match(o2, constr(V @ V.T))
    elif method == "cg_normal_matvec":
        _match(ops.cg_normal_matvec(Vt)(Ut), U + adjoint(constr(sym)) @ V)
    elif method == "obj_value":
        assert float(ops.obj_value(Ut, Vt)) == pytest.approx(
            np.sum(C * sym), rel=RTOL)
    elif method == "apply_c":
        _match(ops.apply_c(Ut), C @ U)
    elif method == "apply_a":
        _match(ops.apply_a(wt, Ut), adjoint(w) @ U)
    elif method == "apply_w":
        _match(ops.apply_w(wt, Ut, obj_coef=2.5), (2.5 * C + adjoint(w)) @ U)
    elif method == "apply_w_no_obj":
        _match(ops.apply_w(wt, Ut, include_obj=False), adjoint(w) @ U)
    else:
        raise AssertionError(method)


def test_general_adjointness(gpair):
    """<A(sym(U V^T)), w> = <U, A*(w) V>."""
    Ut, Vt = torch.tensor(gpair.U), torch.tensor(gpair.V)
    wt = torch.tensor(gpair.w)
    lhs = float(torch.dot(gpair.t.constr_vals(Ut, Vt), wt))
    rhs = float(torch.sum(Ut * gpair.t.apply_a(wt, Vt)))
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-300)


@pytest.mark.parametrize("kind", ["sparse", "diag"])
def test_general_matches_dense_constraint_stack(kind):
    """The (m, n, n) stack of ``dense_constraint_matrices`` (the port's copy
    of the JAX package's test reference) gives the same A and A*."""
    g = _GeneralPair(kind)
    A = dense_constraint_matrices(g.cone)
    U, V, w = g.U, g.V, g.w
    sym = 0.5 * (U @ V.T + V @ U.T)
    assert _rel(g.t.constr_vals(torch.tensor(U), torch.tensor(V)),
                np.einsum("mij,ij->m", A, sym)) <= RTOL
    assert _rel(g.t.apply_a(torch.tensor(w), torch.tensor(U)),
                np.einsum("m,mij->ij", w, A) @ U) <= RTOL


def test_general_cpu_operators_take_the_plain_path(gpair):
    K.reset_counts()
    Ut, wt = torch.tensor(gpair.U), torch.tensor(gpair.w)
    gpair.t.apply_w(wt, Ut)
    gpair.t.constr_vals_pair(Ut, Ut)
    gpair.t.cg_normal_matvec(Ut)(Ut)
    gpair.t.obj_value(Ut, Ut)
    counts = K.counts()
    assert all(launches == 0 for launches, _ in counts.values())
    plain = {name: p for name, (_, p) in counts.items()}
    empty = gpair.kind == "empty"
    assert plain == {"spmm_sym_csr": 1, "diag_rowdot": 0,
                     "diag_normal_matvec": 0, "sym_contract_sum": 1,
                     "coo_contract_segsum": 0 if empty else 2,
                     "spmm_constr_csr": 0 if empty else 2,
                     "lp_constr_segsum": 0, "lp_col_wsum": 0,
                     "gatv2_softmax_agg": 0, "graph_pool": 0,
                     "gatv2_softmax_agg_bwd": 0, "graph_pool_bwd": 0}


# --------------------------------------------------------------------------- #
# dense objectives, several cones, the LP cone
# --------------------------------------------------------------------------- #

MB_LP_SMALL = dict(dims=(100, 80, 60), m=240, n_lp=2000, seed=0)
FAMILIES = ["multiblock", "theta", "multiblock_lp"]


def _family_data(kind):
    """The raw SDPA arrays both packages canonicalize."""
    if kind == "multiblock":
        p = random_multiblock_problem()
        blocks = [JaxSDPABlock(dim=c.n, c_rows=c.c_rows, c_cols=c.c_cols,
                               c_vals=c.c_vals, a_rows=c.a_rows,
                               a_cols=c.a_cols, a_vals=c.a_vals,
                               a_cid=c.a_cid) for c in p.cones]
        return JaxSDPAData(n_constrs=p.m, blocks=blocks, b=p.b)
    if kind == "theta":
        return theta_sdpa(60, 15, seed=60)
    return multiblock_lp_sdpa(**MB_LP_SMALL)


class _Family:
    """One multi-cone problem canonicalized by both packages from the same
    arrays, both packages' internal operator bundles, and seeded inputs in
    the problem's own row and constraint order."""

    def __init__(self, kind):
        self.kind = kind
        data = _family_data(kind)
        self.jp = jax_canonicalize(data)
        self.tp = canonicalize(data)
        self.jc, self.jlp, jorder = jax_build_cone_ops_internal(
            self.jp, jnp.float64)
        self.tc, self.tlp, torder = build_cone_ops_internal(self.tp, "cpu")
        assert jorder is None and torder is None
        rng = np.random.default_rng(11)
        self.ranks = initial_ranks(self.tp)[0]
        self.U = [rng.standard_normal((c.n, r))
                  for c, r in zip(self.tp.cones, self.ranks)]
        self.V = [rng.standard_normal((c.n, r))
                  for c, r in zip(self.tp.cones, self.ranks)]
        self.w = rng.standard_normal(self.tp.m)
        n_lp = self.tp.n_lp_cols
        self.ulp = rng.standard_normal(n_lp) if n_lp else None
        self.vlp = rng.standard_normal(n_lp) if n_lp else None

    def j_in(self, X):
        return tuple(jnp.asarray(ops.permute_rows_in(x))
                     for ops, x in zip(self.jc, X))

    def t_in(self, X):
        return tuple(torch.tensor(x) for x in X)


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    return _Family(request.param)


def test_family_problem_is_the_same_on_both_sides(fam):
    assert len(fam.tp.cones) == len(fam.jp.cones) == (
        1 if fam.kind == "theta" else 3)
    for jc, tc in zip(fam.jp.cones, fam.tp.cones):
        for name in ("c_rows", "c_cols", "c_vals", "a_rows", "a_cols",
                     "a_vals", "a_cid"):
            np.testing.assert_array_equal(getattr(jc, name),
                                          getattr(tc, name))
        # the vectorized union count classifies as the tuple set does
        assert (jc.kind_a, jc.kind_c) == (tc.kind_a, tc.kind_c) == (
            "dense", "dense")
        assert jc.rank_max == tc.rank_max
    assert jax_initial_ranks(fam.jp) == initial_ranks(fam.tp)
    for name in ("c_nrm1", "c_nrm2", "c_nrminf", "b_nrm1", "b_nrm2",
                 "b_nrminf", "n_lp_cols"):
        assert getattr(fam.jp, name) == getattr(fam.tp, name)
    if fam.kind == "multiblock":
        jp = jax_random_multiblock_problem()
        np.testing.assert_array_equal(jp.b, fam.tp.b)
        np.testing.assert_array_equal(jp.cones[2].a_vals,
                                      fam.tp.cones[2].a_vals)
    if fam.kind == "multiblock_lp":
        for name in ("c", "col", "cid", "vals", "nrm2sq"):
            np.testing.assert_array_equal(getattr(fam.jp.lp, name),
                                          getattr(fam.tp.lp, name))
        assert (fam.tp.m, fam.tp.n_lp_cols, fam.tp.lp.col.size) == (
            240, 2000, 6000)


@pytest.mark.parametrize("method", METHODS + ["apply_w_rank1"])
def test_family_cone_operator_matches_jax(fam, method):
    """Every cone of the problem, dense C through ``torch.matmul``, the
    constraints through the general path, against the JAX ``ConeOps``."""
    for k, (j, t) in enumerate(zip(fam.jc, fam.tc)):
        assert t.c_dense is not None and not t.diag_identity
        U, V, w = fam.U[k], fam.V[k], fam.w
        Uj, Vj = (jnp.asarray(j.permute_rows_in(x)) for x in (U, V))
        Ut, Vt, wt = torch.tensor(U), torch.tensor(V), torch.tensor(w)
        wj = jnp.asarray(w)
        out = j.permute_rows_out
        if method == "constr_vals":
            assert _rel(t.constr_vals(Ut, Vt), j.constr_vals(Uj, Vj)) <= RTOL
        elif method == "constr_vals_pair":
            for got, want in zip(t.constr_vals_pair(Ut, Vt),
                                 j.constr_vals_pair(Uj, Vj)):
                assert _rel(got, want) <= RTOL
        elif method == "cg_normal_matvec":
            assert _rel(t.cg_normal_matvec(Vt)(Ut),
                        out(j.cg_normal_matvec(Vj)(Uj))) <= RTOL
        elif method == "obj_value":
            want = float(j.obj_value(Uj, Vj))
            assert abs(float(t.obj_value(Ut, Vt)) - want) <= RTOL * abs(want)
        elif method == "obj_value_same":
            want = float(j.obj_value(Uj, Uj))
            assert abs(float(t.obj_value(Ut, Ut)) - want) <= RTOL * abs(want)
        elif method == "apply_c":
            assert _rel(t.apply_c(Ut), out(j.apply_c(Uj))) <= RTOL
        elif method == "apply_a":
            assert _rel(t.apply_a(wt, Ut), out(j.apply_a(wj, Uj))) <= RTOL
        elif method == "apply_w":
            for coef in (1.0, 2.5):
                assert _rel(t.apply_w(wt, Ut, obj_coef=coef), out(j.apply_w(
                    wj, Uj, obj_coef=coef, include_obj=True))) <= RTOL
            assert _rel(t.apply_w(wt, Ut, include_obj=False),
                        out(j.apply_w(wj, Uj, include_obj=False))) <= RTOL
        elif method == "apply_w_rank1":
            got = t.apply_w(wt, Ut[:, :1].contiguous(), obj_coef=0.5)
            assert _rel(got, out(j.apply_w(wj, Uj[:, :1], obj_coef=0.5,
                                           include_obj=True))) <= RTOL
        else:
            raise AssertionError(method)
        for rank in (1, fam.ranks[k]):
            assert t.constr_flops(rank) == j.constr_flops(rank)
            assert t.apply_flops(rank) == j.apply_flops(rank)


def test_family_dense_objective_matches_dense_reference(fam):
    for k, t in enumerate(fam.tc):
        C = dense_objective_matrix(fam.tp.cones[k])
        U, V = fam.U[k], fam.V[k]
        np.testing.assert_array_equal(t.c_dense.numpy(), C)
        assert _rel(t.apply_c(torch.tensor(U)), C @ U) <= RTOL
        want = np.sum(C * (0.5 * (U @ V.T + V @ U.T)))
        got = float(t.obj_value(torch.tensor(U), torch.tensor(V)))
        assert abs(got - want) <= RTOL * abs(want)


@pytest.mark.parametrize("internal", [True, False],
                         ids=["internal", "public"])
def test_all_constr_vals_and_obj_value_match_jax(fam, internal):
    if internal:
        jc, jlp, tc, tlp = fam.jc, fam.jlp, fam.tc, fam.tlp
        Uj, Vj = fam.j_in(fam.U), fam.j_in(fam.V)
    else:
        jc, jlp = jax_build_cone_ops(fam.jp, jnp.float64)
        tc, tlp = build_cone_ops(fam.tp, "cpu")
        Uj = tuple(jnp.asarray(u) for u in fam.U)
        Vj = tuple(jnp.asarray(v) for v in fam.V)
    assert (tlp is None) == (jlp is None) == (fam.kind != "multiblock_lp")
    lp_j = (() if jlp is None
            else (jnp.asarray(fam.ulp), jnp.asarray(fam.vlp)))
    lp_t = (() if tlp is None
            else (torch.tensor(fam.ulp), torch.tensor(fam.vlp)))
    Ut, Vt = fam.t_in(fam.U), fam.t_in(fam.V)
    want_c = np.asarray(jax_all_constr_vals(jc, jlp, Uj, Vj, *lp_j))
    want_o = float(jax_all_obj_value(jc, jlp, Uj, Vj, *lp_j))
    assert _rel(all_constr_vals(tc, tlp, Ut, Vt, *lp_t), want_c) <= RTOL
    got_o = float(all_obj_value(tc, tlp, Ut, Vt, *lp_t))
    assert abs(got_o - want_o) <= RTOL * abs(want_o)


@pytest.mark.parametrize("method", ["constr_vals", "constr_vals_pair",
                                    "obj_value", "weighted_col_sums",
                                    "nrm2sq"])
def test_lp_ops_match_jax_and_numpy(method):
    """``LPOps`` of the small multi-block + LP instance against the JAX
    ``LPOps`` and against numpy scatter-adds on the problem's own entries."""
    fam = _Family("multiblock_lp")
    lp, j, t = fam.tp.lp, fam.jlp, fam.tlp
    u, v, w = fam.ulp, fam.vlp, fam.w
    ut, vt, wt = torch.tensor(u), torch.tensor(v), torch.tensor(w)
    uj, vj, wj = jnp.asarray(u), jnp.asarray(v), jnp.asarray(w)

    def constr(x):
        out = np.zeros(lp.m)
        np.add.at(out, lp.cid, lp.vals * x[lp.col])
        return out

    K.reset_counts()
    if method == "constr_vals":
        got = t.constr_vals(ut, vt)
        assert _rel(got, j.constr_vals(uj, vj)) <= RTOL
        assert _rel(got, constr(u * v)) <= RTOL
    elif method == "constr_vals_pair":
        q1, q2 = t.constr_vals_pair(ut, vt)
        assert _rel(q1, 2.0 * np.asarray(j.constr_vals(uj, vj))) <= RTOL
        assert _rel(q2, j.constr_vals(vj, vj)) <= RTOL
        assert _rel(q1, constr(2.0 * u * v)) <= RTOL
    elif method == "obj_value":
        want = float(j.obj_value(uj, vj))
        assert abs(float(t.obj_value(ut, vt)) - want) <= RTOL * abs(want)
        assert want == pytest.approx(float(lp.c @ (u * v)), rel=RTOL)
    elif method == "weighted_col_sums":
        cols = np.zeros(lp.n_cols)
        np.add.at(cols, lp.col, lp.vals * w[lp.cid])
        for coef in (1.0, 5.0):
            got = t.weighted_col_sums(wt, obj_coef=coef)
            assert _rel(got, j.weighted_col_sums(wj, obj_coef=coef)) <= RTOL
            assert _rel(got, coef * lp.c + cols) <= RTOL
    else:
        np.testing.assert_array_equal(t.nrm2sq.numpy(), np.asarray(j.nrm2sq))
        assert (t.n_cols, t.m) == (j.n_cols, j.m)
    counts = K.counts()
    assert all(launches == 0 for launches, _ in counts.values())
    used = {"constr_vals": {"lp_constr_segsum"},
            "constr_vals_pair": {"lp_constr_segsum"},
            "weighted_col_sums": {"lp_col_wsum"}}.get(method, set())
    assert {n for n, (_, plain) in counts.items() if plain} == used


def test_constraint_relabel_is_refused_to_shared_constraint_spaces():
    """A MaxCut cone beside an LP cone keeps the problem's constraint order
    on both sides (the relabeling is for a single cone with no LP cone) and
    runs the general path."""
    p = random_maxcut_problem(30, avg_degree=4, seed=3)
    alone, _, order = build_cone_ops_internal(p, "cpu")
    assert alone[0].diag_identity and order is not None
    public, _ = build_cone_ops(p, "cpu")
    assert not public[0].diag_identity and public[0].a_seg is not None
    U = torch.tensor(np.random.default_rng(0).standard_normal((30, 4)))
    got = np.empty(30)
    got[order] = alone[0].constr_vals(U, U).numpy()
    assert _rel(public[0].constr_vals(U, U), got) <= RTOL
