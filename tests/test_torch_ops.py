"""Parity of the port's iterative kernels-around-the-kernels with the JAX
package: CG (``ops/cg.py``), the L-BFGS two-loop recursion (``ops/lbfgs.py``),
the quartic line search (``ops/cubic.py``), the Lanczos recurrence
(``ops/lanczos.py``) and the float64 reductions (``ops/compsum.py``).

Inputs are numpy arrays from fixed seeds handed to both sides.  Tolerances
(float64): CG iterate 1e-10 relative with the same iteration count, L-BFGS
direction 1e-12, line-search tau 1e-10, Lanczos alphas/betas 1e-10 from the
same start vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.ops import cg as jax_cg
from ltr_lowrank_sdp_tpu.ops import compsum as jax_compsum
from ltr_lowrank_sdp_tpu.ops import cubic as jax_cubic
from ltr_lowrank_sdp_tpu.ops import lanczos as jax_lanczos
from ltr_lowrank_sdp_tpu.ops import lbfgs as jax_lbfgs
from ltr_lowrank_sdp_tpu.ops.coneops import (
    build_cone_ops_internal as jax_build_cone_ops_internal)
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_random_maxcut_problem)
from ltr_lowrank_sdp_torch.ops import cg, compsum, cubic, lanczos, lbfgs
from ltr_lowrank_sdp_torch.ops.coneops import build_cone_ops_internal
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# --------------------------------------------------------------------------- #
# CG over the ADMM normal-equation operator
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def normal_ops():
    n, seed = 150, 4
    jc, _, _ = jax_build_cone_ops_internal(
        jax_random_maxcut_problem(n, avg_degree=4, seed=seed), jnp.float64)
    tc, _, _ = build_cone_ops_internal(
        random_maxcut_problem(n, avg_degree=4, seed=seed), "cpu")
    return jc[0], tc[0]


@pytest.mark.parametrize("tol,max_iter,restart", [
    (1e-8, 800, 20),      # converges before the first restart
    (1e-13, 800, 5),      # several residual refreshes
    (1e-13, 7, 20),       # stops at max_iter
], ids=["converge", "restarts", "max_iter"])
def test_cg_matches_jax(normal_ops, tol, max_iter, restart):
    jops, tops = normal_ops
    n, r = jops.n, 6
    rng = np.random.default_rng(11)
    # large scaling so the operator is not close to the identity
    F = 3.0 * rng.standard_normal((n, r))
    b = rng.standard_normal((n, r))
    x0 = rng.standard_normal((n, r))
    # both operators see the same rows: JAX's internal order is a relabel
    Fj = jnp.asarray(jops.permute_rows_in(F))
    bj = jnp.asarray(jops.permute_rows_in(b))
    x0j = jnp.asarray(jops.permute_rows_in(x0))
    jres = jax_cg.cg_solve(jops.cg_normal_matvec(Fj), bj, x0j, tol, max_iter,
                           restart)
    reads = []

    def read(t):
        reads.append(1)
        return [float(t)]

    tres = cg.cg_solve(tops.cg_normal_matvec(torch.tensor(F)),
                       torch.tensor(b), torch.tensor(x0), tol, max_iter,
                       restart, read=read)
    assert tres.iters == int(jres.iters)
    assert tres.converged == bool(jres.converged)
    assert len(reads) == tres.iters + 1      # one host read per iteration
    assert _rel(tres.x.numpy(), jops.permute_rows_out(np.asarray(jres.x))) \
        <= 1e-10


# --------------------------------------------------------------------------- #
# L-BFGS two-loop recursion
# --------------------------------------------------------------------------- #


def _histories(length, pairs, N):
    jh = jax_lbfgs.init_history(N, length, jnp.float64)
    th = lbfgs.init_history(N, length, "cpu")
    for s, y in pairs:
        jh = jax_lbfgs.push_pair(jh, jnp.asarray(s), jnp.asarray(y))
        lbfgs.push_pair(th, torch.tensor(s), torch.tensor(y))
    return jh, th


@pytest.mark.parametrize("n_pairs,n_valid", [(0, None), (1, None), (2, None),
                                             (5, None), (5, 1), (5, 2)])
def test_lbfgs_direction_matches_jax(n_pairs, n_valid):
    rng = np.random.default_rng(7 + n_pairs)
    N = 40
    pairs = []
    for i in range(n_pairs):
        s = rng.standard_normal(N)
        # y close to s keeps the curvature positive; pair 2 has a vanishing
        # curvature and must be stored as a no-op (beta = 0)
        y = s + 0.3 * rng.standard_normal(N) if i != 2 else np.zeros(N)
        pairs.append((s, y))
    jh, th = _histories(3, pairs, N)
    assert th.count == int(jh.count) and th.head == int(jh.head)
    np.testing.assert_allclose(th.beta.numpy(), np.asarray(jh.beta),
                               rtol=1e-12, atol=0)
    g = rng.standard_normal(N)
    want = np.asarray(jax_lbfgs.direction(
        jh, jnp.asarray(g),
        n_valid=None if n_valid is None else jnp.asarray(n_valid)))
    got = lbfgs.direction(th, torch.tensor(g), n_valid=n_valid).numpy()
    assert _rel(got, want) <= 1e-12


# --------------------------------------------------------------------------- #
# quartic line search
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(6))
def test_quartic_linesearch_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    m = 30
    rho = float(10.0 ** rng.uniform(-2, 3))
    lam = rng.standard_normal(m)
    q0 = 0.1 * rng.standard_normal(m)
    q1 = rng.standard_normal(m)
    q2 = np.abs(rng.standard_normal(m))
    p1 = float(rng.standard_normal() * 10)
    p2 = float(rng.standard_normal())
    tau_max = float(rng.uniform(0.5, 3.0))
    jt, jn = jax_cubic.quartic_linesearch(
        rho, jnp.asarray(lam), p1, p2, jnp.asarray(q0), jnp.asarray(q1),
        jnp.asarray(q2), tau_max=tau_max)
    t = lambda a: torch.tensor(a)   # noqa: E731
    tt, tn = cubic.quartic_linesearch(rho, t(lam), torch.tensor(p1),
                                      torch.tensor(p2), t(q0), t(q1), t(q2),
                                      tau_max=tau_max)
    assert tn == int(jn)
    assert abs(tt - float(jt)) <= 1e-10 * max(1.0, abs(float(jt)))


@pytest.mark.parametrize("coeffs", [
    (1.0, -6.0, 11.0, -6.0),       # three real roots 1, 2, 3
    (1.0, 0.0, 0.0, -8.0),         # one real root 2
    (0.0, 0.0, 2.0, -1.0),         # linear
    (1.0, -3.0, 3.0, -1.0),        # triple root 1
])
def test_cubic_roots_match_jax(coeffs):
    jr, jn = jax_cubic.cubic_roots(*(jnp.asarray(c) for c in coeffs))
    tr, tn = cubic.cubic_roots(*coeffs)
    assert tn == int(jn)
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-10, atol=1e-10)


# --------------------------------------------------------------------------- #
# Lanczos
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,k", [(60, 20), (25, 40)])
def test_lanczos_matches_jax_from_the_same_start(n, k):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T)
    key = jax.random.PRNGKey(3)
    # the JAX recurrence draws its start vector from the key; hand the
    # same vector to the port
    v0 = np.asarray(jax.random.normal(key, (n,), jnp.float64))
    Aj = jnp.asarray(A)
    ja, jb = jax_lanczos.lanczos_tridiag(lambda y: Aj @ y, n, key,
                                         num_iters=k, dtype=jnp.float64)
    At = torch.tensor(A)
    ta, tb = lanczos.lanczos_tridiag(lambda y: At @ y, n, torch.tensor(v0),
                                     num_iters=k)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jb)).max())
    assert lanczos.tridiag_min_eig_resid(ta, tb) == pytest.approx(
        jax_lanczos.tridiag_min_eig_resid(ja, jb), rel=1e-9, abs=1e-9)
    if k >= n:      # a full recurrence finds the exact minimum
        assert lanczos.tridiag_min_eig_resid(ta, tb)[0] == pytest.approx(
            np.linalg.eigvalsh(A)[0], abs=1e-9)


def test_oracle_rank_gram_matches_jax():
    rng = np.random.default_rng(5)
    F = rng.standard_normal((50, 4)) @ rng.standard_normal((4, 9))
    want = jax_lanczos.oracle_rank_gram(jnp.asarray(F))
    assert lanczos.oracle_rank_gram(torch.tensor(F)) == want == 4
    assert lanczos.oracle_rank_gram(F) == want


# --------------------------------------------------------------------------- #
# float64 reductions
# --------------------------------------------------------------------------- #


def test_compsum_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((300, 7)) * 1e3
    y = rng.standard_normal((300, 7))
    assert float(compsum.csum(torch.tensor(x))) == pytest.approx(
        float(jax_compsum.csum(jnp.asarray(x))), rel=1e-12)
    assert float(compsum.cvdot(torch.tensor(x), torch.tensor(y))) == \
        pytest.approx(float(jax_compsum.cvdot(jnp.asarray(x),
                                              jnp.asarray(y))), rel=1e-12)
    with pytest.raises(NotImplementedError, match="later slice"):
        compsum.csum(torch.zeros(3, dtype=torch.float32))
