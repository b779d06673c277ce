"""HALLaR's inner FISTA step on the loop-body kernels K14-K16 and K5's union
layout of A and C: on the CPU (their plain versions) against the JAX
package's ``_make_fista`` and ``_make_aipp`` and its ``_Ops.AX`` / ``CX``,
and the machine bit for bit against a per-step loop in float32 and on the
prox subproblem; on the card (``-m cuda``, no JAX there: run with
``--noconftest``) each kernel against its plain version on the same inputs,
eagerly and replayed from a CUDA graph.

    python -m pytest --noconftest tests/test_torch_hallar_fused.py -m cuda

A sum of N terms is held to gamma_N sum |terms| of the exact sum, gamma_N =
N eps / (1 - N eps) (so the kernel's and the plain version's sums to twice
that of each other); an elementwise output to 4 eps max |plain|; a decision
(grow, commit, done) must be the plain version's."""

import math

import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_torch.hallar import solver as TS
from ltr_lowrank_sdp_torch.ops import kernels as K

cuda = pytest.mark.cuda

C5 = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_graph(n, p, seed):
    rng = np.random.default_rng(seed)
    return [(i, j) for i in range(n) for j in range(i + 1, n)
            if rng.random() < p]


def _problem(name):
    if name == "mss_c5":
        return TS.build_mss_problem(C5, 5)
    if name.startswith("mss_"):
        n = int(name[4:])
        return TS.build_mss_problem(_random_graph(n, 4.0 / n, 1), n)
    from ltr_lowrank_sdp_torch.problem import canonicalize
    from ltr_lowrank_sdp_torch.testing import (matcomp_nuclear_norm,
                                               matcomp_sdpa)

    k = int(name[7:]) if name[7:] else 20     # "matcomp" or "matcompNN"
    return TS.SpectraplexProblem.from_sdp_problem(
        canonicalize(matcomp_sdpa(k, k, 2, 1.0, 0)),
        3 * matcomp_nuclear_norm(k, k, 2, 0))


def _jax_problem(pt):
    from ltr_lowrank_sdp_tpu.hallar import solver as JS

    return JS, JS.SpectraplexProblem(**{f: getattr(pt, f) for f in (
        "n", "m", "b", "tau", "c_rows", "c_cols", "c_vals", "a_rows",
        "a_cols", "a_vals", "a_cid")})


def _inputs(pt, r, seed):
    """(Y0 on the ball, p, beta, L0) from one numpy seed."""
    rng = np.random.default_rng(seed)
    Y0 = rng.normal(size=(pt.n, r))
    Y0 *= math.sqrt(pt.tau) / np.linalg.norm(Y0)
    return Y0, rng.normal(size=pt.m), 10.0 * rng.uniform(0.5, 2.0), 3.0


# --------------------------------------------------------------------------- #
# the CPU: the port's inner loop against the JAX package's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("cap", [1, 6])
@pytest.mark.parametrize("name", ["mss_c5", "matcomp"])
def test_run_fista_matches_jax_make_fista(name, cap):
    """One step and a few: the same committed steps and L, Y to 1e-12."""
    import jax
    import jax.numpy as jnp

    pt = _problem(name)
    JS, pj = _jax_problem(pt)
    Y0, p, beta, L0 = _inputs(pt, 3, 17)
    Yj, Lj, kj = jax.jit(JS._make_fista(JS._Ops(pj, jnp.float64),
                                        JS.HallarParams(maxiter_fista=cap)))(
        jnp.asarray(Y0), jnp.asarray(p), jnp.asarray(beta), L0)
    ops = TS._Ops(pt, torch.float64, "cpu")
    Yt, Lt, kt = TS.fista(ops, TS.HallarParams(maxiter_fista=cap),
                          torch.tensor(Y0), torch.tensor(p), beta,
                          torch.tensor(L0, dtype=torch.float64),
                          TS._Counters())
    assert kt == int(kj) == cap
    assert float(Lt) == float(Lj)
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("cap", [1, 6])
@pytest.mark.parametrize("name", ["mss_c5", "matcomp"])
def test_aipp_prox_round_matches_jax_make_aipp(name, cap):
    """``_make_aipp`` with one prox round (``aipp_max_prox = 1``): the same
    committed steps and L, W to 1e-12."""
    import jax
    import jax.numpy as jnp

    pt = _problem(name)
    JS, pj = _jax_problem(pt)
    Y0, p, beta, L0 = _inputs(pt, 2, 23)
    kw = dict(inner_solver="aipp", aipp_max_prox=1, maxiter_fista=cap)
    Wj, Lj, kj = jax.jit(JS._make_aipp(JS._Ops(pj, jnp.float64),
                                       JS.HallarParams(**kw)))(
        jnp.asarray(Y0), jnp.asarray(p), jnp.asarray(beta), L0)
    ops = TS._Ops(pt, torch.float64, "cpu")
    Wt, Lt, kt = TS.aipp(ops, TS.HallarParams(**kw), torch.tensor(Y0),
                         torch.tensor(p), beta,
                         torch.tensor(L0, dtype=torch.float64),
                         TS._Counters())
    assert kt == int(kj) == cap
    assert float(Lt) == float(Lj)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12),
                                        ("float32", 2e-6)])
@pytest.mark.parametrize("name", ["mss_c5", "mss_30", "matcomp"])
def test_axc_plain_matches_jax_ax_and_cx(name, dtype, tol):
    """``axc_plain`` and ``_Ops.axc`` on the CPU: [AX, CX] of the JAX
    package, relative to the largest; the two the same bits."""
    import jax.numpy as jnp

    pt = _problem(name)
    JS, pj = _jax_problem(pt)
    jops = JS._Ops(pj, jnp.dtype(dtype))
    ops = TS._Ops(pt, TS._DTYPES[dtype], "cpu")
    Y = np.random.default_rng(4).normal(size=(pt.n, 4)).astype(dtype)
    Yt = torch.tensor(Y)
    got = K.axc_plain(ops.a_seg, ops.c_rows, ops.c_cols, ops.c_dbl, Yt)
    assert torch.equal(got, ops.axc(Yt)) and got.dtype == Yt.dtype
    want = np.concatenate([np.asarray(jops.AX(jnp.asarray(Y))),
                           [float(jops.CX(jnp.asarray(Y)))]])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name, long_c", [("mss_c5", False), ("mss_30", True),
                                          ("matcomp", True)])
def test_union_layout_puts_c_at_segment_m(name, long_c):
    """``_Ops.ac_seg``: A's segments as ``a_seg`` has them, then C's
    entries as segment m with the coefficients ``c_dbl``, cut into
    K5_CHUNK-entry chunks where it is long; K5's plain version on it gives
    [AX, CX]."""
    pt = _problem(name)
    ops = TS._Ops(pt, torch.float64, "cpu")
    a, ac, m = ops.a_seg, ops.ac_seg, pt.m
    nnz_a = a.nnz
    assert ac.m == m + 1 and ac.nnz == nnz_a + ops.c_rows.numel()
    assert torch.equal(ac.seg_ptr[:m + 1], a.seg_ptr)
    assert int(ac.seg_ptr[m + 1]) == ac.nnz
    assert torch.equal(ac.rows[:nnz_a], a.rows)
    assert torch.equal(ac.cols[:nnz_a], a.cols)
    assert torch.equal(ac.coef[:nnz_a], a.coef)
    assert torch.equal(ac.rows[nnz_a:], ops.c_rows)
    assert torch.equal(ac.cols[nnz_a:], ops.c_cols)
    assert torch.equal(ac.coef[nnz_a:], ops.c_dbl)
    is_long = ac.long_seg is not None and m in ac.long_seg.tolist()
    assert is_long == long_c == (ops.c_rows.numel() >= K.K5_LONG_SEGMENT)
    if is_long:
        j = ac.long_seg.tolist().index(m)
        lo, hi = int(ac.long_ptr[j]), int(ac.long_ptr[j + 1])
        ch = ac.chunk_ptr[lo:hi].numpy()
        assert ch[0, 0] == nnz_a and ch[-1, 1] == ac.nnz
        assert (ch[1:, 0] == ch[:-1, 1]).all()
        assert (ch[:, 1] - ch[:, 0] <= K.K5_CHUNK).all()
    Y = torch.tensor(np.random.default_rng(5).normal(size=(pt.n, 3)))
    want = ops.axc(Y)
    got = K.coo_contract_segsum_plain(ac, Y, Y)
    assert torch.allclose(got, want, rtol=0, atol=1e-12 * want.abs().max())


def _per_step(ops, params, Y0, L0, val, val_grad):
    """The reference's loop step by step in the port's arithmetic, with the
    machine's stop tolerance (floored at STOP_TOL_EPS epsilons)."""
    tol = max(params.err_tol_fista,
              TS.STOP_TOL_EPS * torch.finfo(Y0.dtype).eps)
    Y = Z = Y0
    tk = torch.ones((), dtype=Y0.dtype)
    L = torch.as_tensor(L0, dtype=Y0.dtype).clone()
    k, done = 0, False
    while not done and k < params.maxiter_fista:
        fz, gz = val_grad(Z)
        while True:
            Yn = ops.project(Z - gz / L)
            fy = val(Yn)
            diff = Yn - Z
            ub = fz + TS._vdot(gz, diff) + 0.5 * L * TS._vdot(diff, diff)
            if not bool((fy > ub + 1e-12) & (L < 1e12)):
                break
            L = L * params.L_inc_fista
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        Zn = Yn + ((tk - 1.0) / tn) * (Yn - Y)
        crit = L * torch.linalg.vector_norm(Yn - Z)
        done = bool(crit <= tol * (1.0 + torch.linalg.vector_norm(Yn)))
        Y, Z, tk = Yn, Zn, tn
        L = torch.clamp(L / params.L_inc_fista, min=params.L0_fista)
        k += 1
    return Y, L, k


@pytest.mark.parametrize("chunk", [1, 64])
@pytest.mark.parametrize("name, dtype, subproblem, err_tol", [
    ("mss_c5", "float32", "al", 1e-8),
    ("matcomp", "float32", "al", 1e-8),
    ("mss_30", "float32", "prox", 1e-8),
    ("matcomp", "float64", "prox", 1e-8),
    ("mss_c5", "float64", "prox", 1e-4),     # stops by the stationarity test
])
def test_machine_reproduces_the_per_step_loop(name, dtype, subproblem,
                                              err_tol, chunk):
    """The refactored machine step, bit for bit: the same iterate, L and
    committed steps as the per-step loop."""
    pt = _problem(name)
    dt = TS._DTYPES[dtype]
    ops = TS._Ops(pt, dt, "cpu")
    params = TS.HallarParams(maxiter_fista=120, err_tol_fista=err_tol)
    rng = np.random.default_rng(31)
    Y0 = ops.project(torch.tensor(rng.normal(size=(pt.n, 3)), dtype=dt))
    p = torch.tensor(rng.normal(size=pt.m), dtype=dt)
    if subproblem == "al":
        val, val_grad = TS.al_functions(ops, p, 10.0)
    else:
        val, val_grad = TS.prox_functions(ops, p, 10.0, Y0, 0.25)
    L0 = torch.tensor(3.0, dtype=dt)
    Ym, Lm, km = TS.run_fista(ops, params, Y0, L0, val, val_grad,
                              TS._Counters(), chunk=chunk)
    Yp, Lp, kp = _per_step(ops, params, Y0, L0, val, val_grad)
    assert km == kp and km > 1
    assert torch.equal(Ym, Yp) and torch.equal(Lm, Lp)


def test_step_counts_plain_calls_of_the_loop_kernels(monkeypatch):
    """A CPU machine step takes K14 once, K15's pair once (its plain
    version: two ``al_value_plain`` calls, which ``plain_calls`` counts as
    two) and K16 once, K5 and K4 twice (``axc``) and K6 once; no launch."""
    pt = _problem("mss_c5")
    ops = TS._Ops(pt, torch.float64, "cpu")
    Y0 = ops.project(torch.ones((5, 2), dtype=torch.float64))
    val, val_grad = TS.al_functions(ops, torch.zeros(5, dtype=torch.float64),
                                    10.0)
    st = TS.fista_init(Y0, 1.0, val_grad)
    pairs, plain_values = [], []
    pair, plain = K.al_value_pair, K.al_value_plain
    monkeypatch.setattr(K, "al_value_pair",
                        lambda *a: pairs.append(1) or pair(*a))
    monkeypatch.setattr(K, "al_value_plain",
                        lambda *a: plain_values.append(1) or plain(*a))
    K.reset_counts()
    TS._machine_step(st, ops, TS.HallarParams(), val, val_grad)
    assert len(pairs) == 1 and len(plain_values) == 2
    assert K.loop_counts() == {"fista_candidate": (0, 1),
                               "al_value": (0, 2), "fista_commit": (0, 1)}
    c = K.counts()
    assert c["coo_contract_segsum"] == c["sym_contract_sum"] == (0, 2)
    assert c["spmm_constr_csr"] == (0, 1)
    with pytest.raises(TypeError, match="al_functions"):
        TS.run_fista(ops, TS.HallarParams(), Y0, 1.0, val,
                     lambda Y: val_grad(Y), TS._Counters())


def test_fused_grid_depends_on_the_size_alone():
    assert K.fused_blocks(1) == 1
    assert K.fused_blocks(K.FUSED_THREADS + 1) == 2
    assert K.fused_blocks(10 ** 8) == K.FUSED_MAX_BLOCKS
    # the sources' block sizes are the wrappers'
    for name in K.LOOP_KERNELS:
        src = (K.CSRC_DIR / f"{name}.cu").read_text()
        assert f"constexpr int kThreads = {K.FUSED_THREADS};" in src
    k14 = (K.CSRC_DIR / "fista_candidate.cu").read_text()
    assert (f"constexpr int kClusterThreads = {K.K14_CLUSTER_THREADS};"
            in k14)
    assert f"constexpr int kClusterCtas = {K.K14_CLUSTER_CTAS};" in k14
    for v in K.K14_CLUSTER_VALS:
        assert f"case {v}: return launch_cluster<T, PROX, {v}>" in k14
    assert K.K14_CLUSTER_MAX_N == 65536
    k15 = (K.CSRC_DIR / "al_value.cu").read_text()
    assert K.K15_THREADS == K.FUSED_THREADS
    assert f"constexpr int kChunks = {K.K15_CHUNKS};" in k15
    assert K.k15_blocks(1, torch.float64) == 1
    assert K.k15_blocks(216171, torch.float64) == 212
    assert K.k15_blocks(216171, torch.float32) == 106
    assert K.k15_blocks(10 ** 9, torch.float64) == K.K15_MAX_BLOCKS


@pytest.mark.parametrize("N, want", [
    (1, (16, 1)), (6000, (16, 1)), (16384, (16, 2)), (16385, (16, 4)),
    (21000, (16, 4)), (65536, (16, 8)), (65537, None)])
def test_k14_plan_depends_on_n_alone(N, want):
    """K14's plan and the cluster's shape are a function of N alone: one
    cluster up to K14_CLUSTER_MAX_N that holds every value in registers,
    the two-launch plan on fused_blocks(N) above."""
    plan = K.k14_plan(N)
    assert plan == K.k14_plan(N)
    if want is None:
        assert plan == K.K14Plan(0, blocks=K.fused_blocks(N))
        with pytest.raises(ValueError, match="exceeds"):
            K.k14_cluster_plan(N)
        return
    assert (plan.cluster, plan.vals) == want
    assert plan.cluster * K.K14_CLUSTER_THREADS * plan.vals >= N
    assert plan == K.k14_cluster_plan(N)


def _two_call_step(st, ops, params, sub):
    """The machine step with K15 as two single-point calls, each after its
    own K5: K14, K5 and K15 at the candidate, K5 and K15 (with K6's
    weights) at the extrapolated point, K6, K16 (the plain versions)."""
    W, prox = sub.W, sub.W is not None
    Yc, Zn, sc = K.fista_candidate_plain(st.Z, st.gz, st.L, st.Y, st.tk, W,
                                         ops.sqrt_tau)
    fy = K.al_value_plain(ops.axc(Yc), ops.b, sub.p, sub.beta, sub.lam,
                          sc[K.SC_WY] if prox else None)
    fzn = K.al_value_plain(ops.axc(Zn), ops.b, sub.p, sub.beta, sub.lam,
                           sc[K.SC_WZ] if prox else None, ops.wbuf)
    S = K.spmm_constr_csr_plain(ops.s_csr, ops.wbuf, Zn)
    tol = max(params.err_tol_fista,
              TS.STOP_TOL_EPS * torch.finfo(Yc.dtype).eps)
    Y, Z, gz, tk, L, k, done, fz = K.fista_commit_plain(
        st.Y, st.Z, st.gz, st.tk, st.L, st.k, st.done, st.fz, Yc, Zn, sc,
        fy, fzn, S, W, sub.lam, params.maxiter_fista, params.L_inc_fista,
        params.L0_fista, tol)
    return TS.FistaState(Y=Y, Z=Z, tk=tk, L=L, k=k, done=done, fz=fz, gz=gz)


@pytest.mark.parametrize("name, dtype, subproblem", [
    ("matcomp", "float64", "al"), ("mss_30", "float32", "prox")])
def test_reordered_machine_step_keeps_the_cpu_bits(name, dtype, subproblem):
    """The machine step with K15's pair (both K5 calls first, then both
    values) gives the bits of the step with two single-point K15 calls
    over a chunk: Y, Z, L, k and fz equal at every step."""
    pt = _problem(name)
    dt = TS._DTYPES[dtype]
    ops = TS._Ops(pt, dt, "cpu")
    params = TS.HallarParams(maxiter_fista=10 ** 6)
    rng = np.random.default_rng(37)
    Y0 = ops.project(torch.tensor(rng.normal(size=(pt.n, 3)), dtype=dt))
    p = torch.tensor(rng.normal(size=pt.m), dtype=dt)
    if subproblem == "al":
        val, val_grad = TS.al_functions(ops, p, 10.0)
    else:
        val, val_grad = TS.prox_functions(ops, p, 10.0, Y0, 0.25)
    sub = TS._subproblem(val_grad)
    st = old = TS.fista_init(Y0, torch.tensor(3.0, dtype=dt), val_grad)
    grows = 0
    for _ in range(TS.FISTA_CHUNK):
        L0 = float(st.L)
        st = TS._machine_step(st, ops, params, val, val_grad)
        old = _two_call_step(old, ops, params, sub)
        for f in ("Y", "Z", "L", "k", "fz"):
            assert torch.equal(getattr(st, f), getattr(old, f)), f
        grows += float(st.L) > L0
    assert int(st.k) + grows == TS.FISTA_CHUNK and 0 < grows


def _gamma_of(n, dt) -> float:
    e = torch.finfo(dt).eps
    return n * e / (1 - n * e)


@pytest.mark.parametrize("prox", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(5, 2), (3000, 2), (3000, 7), (1024, 8)])
def test_k14_cluster_order_within_gamma(shape, dtype, prox):
    """K14's cluster plan evaluated on the host in its order
    (``fista_candidate_order``): each sum within gamma_N sum |terms| of the
    exact sum, Yc and Zn within 4 eps max |plain| of the plain version's,
    tn its bits."""
    rng = np.random.default_rng(shape[0] + shape[1])
    Z, gz, Y, W = (torch.tensor(rng.normal(size=shape), dtype=dtype)
                   for _ in range(4))
    W = W if prox else None
    L = torch.tensor(3.5, dtype=dtype)
    tk = torch.tensor(1.75, dtype=dtype)
    sqrt_tau = 0.5 * math.sqrt(Z.numel())
    Yc, Zn, sc = K.fista_candidate_order(Z, gz, L, Y, tk, W, sqrt_tau)
    Ycp, Znp, scp = K.fista_candidate_plain(Z, gz, L, Y, tk, W, sqrt_tau)
    eps = torch.finfo(dtype).eps
    for a, b in ((Yc, Ycp), (Zn, Znp)):
        assert float((a - b).abs().max()) <= 4 * eps * float(b.abs().max())
    d = (Yc - Z).double()
    sums = [(sc[K.SC_GD], gz.double() * d, 0), (sc[K.SC_DD], d * d, 0),
            (sc[K.SC_DNORM].double() ** 2, d * d, 3),
            (sc[K.SC_YNORM].double() ** 2, Yc.double() ** 2, 3)]
    if prox:
        sums += [(sc[K.SC_WY], (Yc - W).double() ** 2, 0),
                 (sc[K.SC_WZ], (Zn - W).double() ** 2, 0)]
    for got, terms, extra in sums:
        exact = math.fsum(terms.ravel().tolist())
        mag = math.fsum(terms.abs().ravel().tolist())
        assert abs(float(got) - exact) <= _gamma_of(
            terms.numel() + extra, dtype) * mag + 1e-300
    assert float(sc[K.SC_TN]) == float(scp[K.SC_TN])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [3, 1000, 216171])
def test_k15_order_within_gamma(m, dtype):
    """K15 evaluated on the host in its order (``al_value_order``) within
    gamma_{m+4} of the value's exact sum of magnitudes of the plain one,
    and the CPU pair is two plain calls, candidate first."""
    rng = np.random.default_rng(m)
    ax, ax2 = (torch.tensor(rng.normal(size=m + 1), dtype=dtype)
               for _ in range(2))
    b, p = (torch.tensor(rng.normal(size=m), dtype=dtype) for _ in range(2))
    wsq = torch.tensor(0.75, dtype=dtype)
    for lam, w in ((1.0, None), (0.25, wsq)):
        got = K.al_value_order(ax, b, p, 12.5, lam, w)
        want = K.al_value_plain(ax, b, p, 12.5, lam, w)
        r = (ax[:m] - b).double()
        mag = lam * (abs(float(ax[m])) + float((p.double() * r).abs().sum())
                     + 6.25 * float((r * r).sum())) + 0.375
        assert abs(float(got) - float(want)) <= 2 * _gamma_of(
            m + 4, dtype) * mag
    wk, wp = torch.empty(m + 1, dtype=dtype), torch.empty(m + 1, dtype=dtype)
    fy, fzn = K.al_value_pair(ax, ax2, b, p, 12.5, 0.25, wsq, wsq, wk)
    assert torch.equal(fy, K.al_value_plain(ax, b, p, 12.5, 0.25, wsq))
    assert torch.equal(fzn, K.al_value_plain(ax2, b, p, 12.5, 0.25, wsq, wp))
    assert torch.equal(wk, wp)


# --------------------------------------------------------------------------- #
# the card: each kernel against its plain version
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    K.build_kernels()
    return torch.device("cuda", torch.cuda.current_device())


def _gamma(n, dt) -> float:
    e = torch.finfo(dt).eps
    return n * e / (1 - n * e)


def _fsum(t: torch.Tensor) -> float:
    return math.fsum(t.double().cpu().numpy().ravel().tolist())


def _sum_ok(got, terms, extra=0) -> bool:
    """|got - exact sum of terms| <= gamma_{N + extra} sum |terms|."""
    n = terms.numel() + extra
    return abs(float(got) - _fsum(terms)) <= _gamma(n, terms.dtype) * _fsum(
        terms.abs()) + 1e-300


def _close(a, b) -> bool:
    eps = torch.finfo(b.dtype).eps
    return bool((a - b).abs().max() <= 4 * eps * b.abs().max())


def _step_inputs(pt, r, dtype, prox, dev, seed=3):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64).to(
            dtype).to(dev)

    ops = TS._Ops(pt, dtype, dev)
    Z, gz, Y = rnd(pt.n, r), rnd(pt.n, r), rnd(pt.n, r)
    W = rnd(pt.n, r) if prox else None
    L = torch.tensor(3.5, dtype=dtype, device=dev)
    tk = torch.tensor(1.75, dtype=dtype, device=dev)
    return ops, Z, gz, Y, W, L, tk


def _replayed(fn, reset=None):
    """fn() captured into a CUDA graph and replayed twice: the outputs of
    each replay (after ``reset()``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        if reset is not None:
            reset()
        fn()                                # warm-up
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    outs = []
    for _ in range(2):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
        outs.append(tuple(t.clone() for t in out))
    return outs


CASES = [(r, dt, prox) for r in (1, 3, 8, 20)
         for dt in (torch.float64, torch.float32) for prox in (False, True)]


@cuda
@pytest.mark.parametrize("r, dtype, prox", CASES)
def test_k14_fista_candidate_on_the_card(dev, r, dtype, prox):
    pt = _problem("mss_300")
    ops, Z, gz, Y, W, L, tk = _step_inputs(pt, r, dtype, prox, dev)
    Yc, Zn, sc = K.fista_candidate(Z, gz, L, Y, tk, W, ops.sqrt_tau)
    Ycp, Znp, scp = K.fista_candidate_plain(Z, gz, L, Y, tk, W, ops.sqrt_tau)
    assert _close(Yc, Ycp) and _close(Zn, Znp)
    d = Yc - Z
    assert _sum_ok(sc[K.SC_GD], gz * d) and _sum_ok(sc[K.SC_DD], d * d)
    assert _sum_ok(sc[K.SC_DNORM].double() ** 2, d * d, 3)
    assert _sum_ok(sc[K.SC_YNORM].double() ** 2, Yc * Yc, 3)
    if prox:
        assert _sum_ok(sc[K.SC_WY], (Yc - W) ** 2)
        assert _sum_ok(sc[K.SC_WZ], (Zn - W) ** 2)
    else:
        assert float(sc[K.SC_WY]) == float(sc[K.SC_WZ]) == 0.0
    assert float(sc[K.SC_TN]) == float(scp[K.SC_TN])
    want = K.fista_candidate_order(Z, gz, L, Y, tk, W, ops.sqrt_tau)
    assert all(torch.equal(a.cpu(), b) for a, b in zip((Yc, Zn, sc), want))
    again = K.fista_candidate(Z, gz, L, Y, tk, W, ops.sqrt_tau)
    for out in [again] + _replayed(
            lambda: K.fista_candidate(Z, gz, L, Y, tk, W, ops.sqrt_tau)):
        assert all(torch.equal(a, b) for a, b in zip(out, (Yc, Zn, sc)))


K14_SHAPES = [(3000, 2), (3000, 7), (1024, 8),
              (K.K14_CLUSTER_MAX_N // 8 + 1, 8)]


@cuda
@pytest.mark.parametrize("prox", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", K14_SHAPES)
def test_k14_plans_on_the_card(dev, shape, dtype, prox):
    """Every plan of K14 that holds N (the cluster and the two-launch
    plan) against the plain version: sums within gamma_N, Yc and Zn within
    4 eps; the cluster plan the bits of its host order; each replayed with
    the same bits."""
    g = torch.Generator().manual_seed(shape[0])
    Z, gz, Y, W = (torch.randn(*shape, generator=g, dtype=torch.float64)
                   .to(dtype).to(dev) for _ in range(4))
    W = W if prox else None
    L = torch.tensor(3.5, dtype=dtype, device=dev)
    tk = torch.tensor(1.75, dtype=dtype, device=dev)
    sqrt_tau = 0.5 * math.sqrt(Z.numel())
    N = Z.numel()
    plans = [K.K14Plan(0, blocks=K.fused_blocks(N))]
    if N <= K.K14_CLUSTER_MAX_N:
        plans.append(K.k14_cluster_plan(N))
    assert K.k14_plan(N) in plans
    Ycp, Znp, scp = K.fista_candidate_plain(Z, gz, L, Y, tk, W, sqrt_tau)
    host = (K.fista_candidate_order if N <= K.K14_CLUSTER_MAX_N else None)
    for plan in plans:
        def run(plan=plan):
            return K.fista_candidate_with(plan, Z, gz, L, Y, tk, W, sqrt_tau)

        Yc, Zn, sc = run()
        assert _close(Yc, Ycp) and _close(Zn, Znp), plan
        d = Yc - Z
        assert _sum_ok(sc[K.SC_GD], gz * d) and _sum_ok(sc[K.SC_DD], d * d)
        assert _sum_ok(sc[K.SC_YNORM].double() ** 2, Yc * Yc, 3)
        if prox:
            assert _sum_ok(sc[K.SC_WZ], (Zn - W) ** 2)
        assert float(sc[K.SC_TN]) == float(scp[K.SC_TN])
        if plan.cluster and host is not None:
            want = host(Z, gz, L, Y, tk, W, sqrt_tau, plan)
            assert all(torch.equal(a.cpu(), b)
                       for a, b in zip((Yc, Zn, sc), want)), plan
        for out in _replayed(run):
            assert all(torch.equal(a, b) for a, b in zip(out, (Yc, Zn, sc)))


@cuda
@pytest.mark.parametrize("r, dtype, prox", CASES)
def test_union_k5_and_k15_al_value_on_the_card(dev, r, dtype, prox):
    pt = _problem("matcomp40")
    ops, Z, _, _, W, _, _ = _step_inputs(pt, r, dtype, prox, dev)
    ac = ops.ac_seg
    axc = ops.axc(Z)
    plain = K.coo_contract_segsum_plain(ac, Z, Z)
    assert torch.equal(axc[:pt.m], K.coo_contract_segsum(ops.a_seg, Z, Z))
    absseg = K.SegCOO(n=ac.n, m=ac.m, seg_ptr=ac.seg_ptr, rows=ac.rows,
                      cols=ac.cols, coef=ac.coef.abs())
    mags = K.coo_contract_segsum_plain(absseg, Z.abs(), Z.abs())
    lens = (ac.seg_ptr[1:] - ac.seg_ptr[:-1]).to(mags.dtype)
    gam = torch.tensor([_gamma(int(n) * r + r, dtype) for n in lens.tolist()],
                       dtype=mags.dtype, device=dev)
    assert bool(((axc - plain).abs() <= 2 * gam * mags).all())
    p = torch.randn(pt.m, dtype=torch.float64, device=dev).to(dtype)
    beta, lam = 12.5, (0.25 if prox else 1.0)
    wsq = torch.tensor(0.75, dtype=dtype, device=dev) if prox else None
    wk = torch.full((pt.m + 1,), float("nan"), dtype=dtype, device=dev)
    wp = wk.clone()
    v = K.al_value(axc, ops.b, p, beta, lam, wsq, wk)
    vp = K.al_value_plain(axc, ops.b, p, beta, lam, wsq, wp)
    assert torch.equal(wk, wp) and float(wk[pt.m]) == 1.0
    assert torch.equal(v.cpu(), K.al_value_order(axc, ops.b, p, beta, lam,
                                                 wsq))
    resid = axc[:pt.m] - ops.b
    mag = lam * (abs(float(axc[pt.m])) + _fsum((p * resid).abs())
                 + 0.5 * beta * _fsum(resid * resid)) + (0.75 if prox else 0)
    assert abs(float(v) - float(vp)) <= 2 * _gamma(pt.m + 4, dtype) * mag
    assert torch.equal(K.al_value(axc, ops.b, p, beta, lam, wsq), v)
    for out in _replayed(lambda: (ops.axc(Z),
                                  K.al_value(axc, ops.b, p, beta, lam, wsq,
                                             wk))):
        assert torch.equal(out[0], axc) and torch.equal(out[1], v)


@cuda
@pytest.mark.parametrize("r, dtype, prox", CASES)
def test_k16_fista_commit_on_the_card(dev, r, dtype, prox):
    pt = _problem("mss_300")
    ops, Z, gz, Y, W, L, tk = _step_inputs(pt, r, dtype, prox, dev)
    Yc, Zn, sc = K.fista_candidate_plain(Z, gz, L, Y, tk, W, ops.sqrt_tau)
    S = torch.randn_like(Z)
    ub = float(0.75 + sc[K.SC_GD] + 0.5 * L * sc[K.SC_DD])
    state0 = (Y, Z, gz, tk, L, torch.tensor(4, device=dev),
              torch.tensor(False, device=dev),
              torch.tensor(0.75, dtype=dtype, device=dev))
    for fy_off, done0, want in ((-1.0, False, "commit"), (1.0, False, "grow"),
                                (-1.0, True, "none")):
        fy = torch.tensor(ub + fy_off * (1 + abs(ub)), dtype=dtype,
                          device=dev)
        fzn = torch.tensor(-2.5, dtype=dtype, device=dev)
        st0 = list(state0)
        st0[6] = torch.tensor(done0, device=dev)
        args = (Yc, Zn, sc, fy, fzn, S, W, 0.5 if prox else 1.0, 100, 2.0,
                1.0, 1e-3)
        want_out = K.fista_commit_plain(*st0, *args)
        st = [t.clone() for t in st0]
        got = K.fista_commit(*st, *args)
        assert all(a is b for a, b in zip(got, st))
        for a, b in zip(got, want_out):
            assert a.dtype == b.dtype
            if a.dtype == torch.bool or a.dtype == torch.int64:
                assert torch.equal(a, b)
            else:
                assert _close(a, b)
        assert (int(got[5]) == 5) == (want == "commit")
        assert (float(got[4]) == 7.0) == (want == "grow")

        def reset():
            for a, b in zip(st, st0):
                a.copy_(b)

        for out in _replayed(lambda: K.fista_commit(*st, *args), reset):
            assert all(torch.equal(a, b) for a, b in zip(out, got))


@cuda
@pytest.mark.parametrize("prox", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [7, 1001, 216171, 1200001])
def test_k15_pair_on_the_card(dev, m, dtype, prox):
    """K15's pair against two plain calls: the weights their bits, each
    value within gamma_{m+4} and the bits of its host order; the same bits
    as two single-point launches and on a replay; unaligned views take the
    value-by-value loads with the same bits.  At m = 1,200,001 the grid is
    capped (K15_MAX_BLOCKS) and threads take chunks past their first
    K15_CHUNKS."""
    g = torch.Generator().manual_seed(m)
    ax, ax2 = (torch.randn(m + 2, generator=g, dtype=torch.float64)
               .to(dtype).to(dev) for _ in range(2))
    b, p = (torch.randn(m + 1, generator=g, dtype=torch.float64)
            .to(dtype).to(dev) for _ in range(2))
    lam = 0.25 if prox else 1.0
    wsq = torch.tensor([0.75, 1.5], dtype=dtype, device=dev)
    w1, w2 = (wsq[0], wsq[1]) if prox else (None, None)
    for sl in (slice(0, None), slice(1, None)):      # aligned, then not
        a1, a2, bb, pp = ax[sl][:m + 1], ax2[sl][:m + 1], b[sl][:m], p[sl][:m]
        wk = torch.full((m + 1,), float("nan"), dtype=dtype, device=dev)
        wp = wk.clone()
        fy, fzn = K.al_value_pair(a1, a2, bb, pp, 12.5, lam, w1, w2, wk)
        fyp, fznp = K.al_value_pair_plain(a1, a2, bb, pp, 12.5, lam, w1, w2,
                                          wp)
        assert torch.equal(wk, wp)
        for got, want, a, w in ((fy, fyp, a1, w1), (fzn, fznp, a2, w2)):
            r = (a[:m] - bb).double()
            mag = lam * (abs(float(a[m])) + _fsum(pp.double() * r)
                         + 6.25 * _fsum(r * r)) + 1.0
            assert abs(float(got) - float(want)) <= 2 * _gamma(
                m + 4, dtype) * mag
            assert torch.equal(got.cpu(), K.al_value_order(a, bb, pp, 12.5,
                                                           lam, w))
        assert torch.equal(fy, K.al_value(a1, bb, pp, 12.5, lam, w1))
        assert torch.equal(fzn, K.al_value(a2, bb, pp, 12.5, lam, w2))
        for out in _replayed(lambda: K.al_value_pair(a1, a2, bb, pp, 12.5,
                                                     lam, w1, w2, wk)):
            assert torch.equal(out[0], fy) and torch.equal(out[1], fzn)


@cuda
@pytest.mark.parametrize("name, nodes", [("matcomp", 8), ("mss_c5", 6)])
def test_machine_step_graph_nodes_on_the_card(dev, name, nodes):
    """A captured machine step: K14 one node, K5 two a call where C is a
    long segment (its dependent reduce), K15's pair one, K6, K16: 8 nodes
    (6 where C is short), every one a kernel."""
    from ltr_lowrank_sdp_torch.testing import captured_node_kinds

    pt = _problem(name)
    ops = TS._Ops(pt, torch.float64, dev)
    g = torch.Generator().manual_seed(5)
    Y0 = ops.project(torch.randn(pt.n, 3, generator=g,
                                 dtype=torch.float64).to(dev))
    val, val_grad = TS.al_functions(
        ops, torch.zeros(pt.m, dtype=torch.float64, device=dev), 10.0)
    st = TS.fista_init(Y0, 1.0, val_grad)
    kinds = captured_node_kinds(lambda: TS._machine_step(
        st, ops, TS.HallarParams(), val, val_grad))
    assert kinds == [0] * nodes
