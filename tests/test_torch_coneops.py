"""Parity of the PyTorch port's MaxCut-family conic operators with the JAX
package's ``ConeOps`` (``ltr_lowrank_sdp_tpu/ops/coneops.py``).

Both packages build the same ``SDPProblem`` from a seed; inputs are numpy
arrays in the problem's original row and constraint order.  The JAX
operators work in a relabeled internal order (``row_order`` for vertices,
``constr_order`` for constraints), the port only relabels constraints, so
every output is mapped back to the original order before comparing.  On the
CPU every operator runs through its kernel's plain PyTorch version.

Tolerance: relative 1e-12 in the 2-norm (float64; the two sides sum in
different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.ops.coneops import (
    build_cone_ops_internal as jax_build_cone_ops_internal)
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_random_maxcut_problem)
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.ops.coneops import ConeOps, build_cone_ops_internal
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem

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
    assert all(plain == 1 for _, plain in counts.values())


def test_unported_cones_raise():
    from ltr_lowrank_sdp_tpu.testing import random_multiblock_problem

    prob = random_multiblock_problem()
    with pytest.raises(NotImplementedError, match="later slice"):
        ConeOps(prob.cones[0], "cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        build_cone_ops_internal(prob, "cpu")
