"""``hallar_solve`` of the port against the JAX package's, on the reference's
own HALLaR spec cases (``tests/test_hallar.py``), with the reference's
Lanczos start vectors injected (``jax.random.normal(PRNGKey(key))``).

Every case gives the JAX solve's outer iterations, final rank and status.
The objectives are held to bounds stated per case, because two float64
programs that differ only in summation order do not follow the same FISTA
path here: a backtracking test that one passes and the other fails by
rounding sends them apart for a while (in the first inner solve of the
200-node MaxCut of ``test_torch_hallar_maxcut.py`` the iterates differ by
2.5e-13 after 100 steps, 9.4e-5 after 3,000, 5.1e-7 after 7,900), and the
stop test ``L ||Y_n - Z|| <= 1e-8 (1 + ||Y_n||)`` then fires at another step
(there: JAX 8,248, the port 7,935).  On the 5-cycle the reference is itself
that sensitive: perturbing its Y0 by 1e-15 relative moves its own final
pobj by 3.1e-7 relative, its dval by 7.0e-8 and its Y by 0.05.  Y is not
unique (Y Q is as good for any orthogonal Q), so X = Y Y^T is compared.
``PYTHONPATH=. python tests/test_torch_hallar_solve.py`` prints these
numbers (:func:`reference_spread`) and the float32 case's per-step evidence
(:func:`float32_stop_evidence`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ltr_lowrank_sdp_torch.hallar import solver as TS
from ltr_lowrank_sdp_tpu.hallar import solver as JS

C5 = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)]
C5_PARAMS = dict(eps_pfeas=1e-6, eps_gap=1e-4, maxiter_hallar=400,
                 init_rank=2, lanczos_iters=10)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_start(dtype):
    """The reference's Lanczos start vector for ``key`` (its
    ``lanczos_min_eig_vec`` draws ``jax.random.normal(PRNGKey(key), (n,),
    dtype)``)."""
    def start(key, n):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(key), (n,),
                                            jnp.dtype(dtype)))
    return start


def min_eig_problem(mod):
    """The trace-bound min-eig case: min <C, X> over tr X <= 1, X >= 0 is
    min(lambda_min(C), 0)."""
    rng = np.random.default_rng(0)
    n = 12
    C = rng.normal(size=(n, n))
    C = (C + C.T) / 2
    iu = np.triu_indices(n)
    return mod.SpectraplexProblem(
        n=n, m=1, b=np.zeros(1), tau=1.0,
        c_rows=iu[0].astype(np.int32), c_cols=iu[1].astype(np.int32),
        c_vals=C[iu],
        a_rows=np.zeros(1, np.int32), a_cols=np.zeros(1, np.int32),
        a_vals=np.zeros(1), a_cid=np.zeros(1, np.int32),
    ), np.linalg.eigvalsh(C)[0]


def solve_both(prob_t, prob_j, **kw):
    dtype = kw.get("dtype", "float64")
    ref = JS.hallar_solve(prob_j, JS.HallarParams(**kw))
    got = TS.hallar_solve(prob_t, TS.HallarParams(**kw), device="cpu",
                          lanczos_start=jax_start(dtype))
    assert (got.iters, got.final_rank, got.converged) == (
        ref.iters, ref.final_rank, ref.converged)
    return got, ref


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def x_err(got, ref):
    Xg, Xr = got.Y @ got.Y.T, ref.Y @ ref.Y.T
    return float(np.abs(Xg - Xr).max() / np.abs(Xr).max())


# (case, pobj / dval bound, X bound).  The 5-cycle's bound is its reference's
# own spread under a 1e-15 perturbation of Y0 (above); the AIPP case's
# inner loop stops by its prox residual, not by maxiter, and the min-eig
# case has no constraint to drift along.
@pytest.mark.parametrize("case, obj_tol, x_tol", [
    ("c5_fista", 1e-6, 1e-6),
    ("c5_aipp", 1e-8, 1e-6),
    ("min_eig", 1e-12, 1e-10),
])
def test_spec_case_matches_the_jax_solve(case, obj_tol, x_tol):
    if case == "min_eig":
        (pt, lam), (pj, _) = min_eig_problem(TS), min_eig_problem(JS)
        got, ref = solve_both(pt, pj, eps_gap=1e-4, maxiter_hallar=200,
                              lanczos_iters=24)
        assert abs(got.pobj - min(lam, 0.0)) < 1e-3
    else:
        kw = dict(C5_PARAMS)
        if case == "c5_aipp":
            # the reference's AIPP takes 491,531 inner steps at the default
            # maxiter_fista; 300 per prox round takes about 16,000 and gives
            # the same iterations, rank and status
            kw.update(inner_solver="aipp", maxiter_fista=300)
        got, ref = solve_both(TS.build_mss_problem(C5, 5),
                              JS.build_mss_problem(C5, 5), **kw)
        assert got.converged and got.pinf <= 1e-5
        assert abs(-got.pobj - np.sqrt(5)) < 2e-3
    print(case, rel(got.pobj, ref.pobj), rel(got.dval, ref.dval),
          x_err(got, ref), got.fista_steps)
    assert rel(got.pobj, ref.pobj) <= obj_tol
    assert rel(got.dval, ref.dval) <= obj_tol
    assert x_err(got, ref) <= x_tol


def counting_jax_steps(monkeypatch):
    """A list that collects the FISTA steps of every inner solve the JAX
    package runs while ``monkeypatch`` is active, read from its jitted inner
    loop by a debug callback."""
    steps, orig = [], JS._make_fista

    def counting(ops, params):
        fista = orig(ops, params)

        def run(Y0, p, beta, L0):
            Y, L, k = fista(Y0, p, beta, L0)
            jax.debug.callback(lambda k: steps.append(int(k)), k)
            return Y, L, k
        return run

    monkeypatch.setattr(JS, "_make_fista", counting)
    return steps


def test_float32_min_eig_matches_the_jax_float32_solve(monkeypatch):
    """float32 (``HallarParams(dtype="float32")``) on K4-K6's float32
    instances, <C, X> summed in float32 as JAX's ``jnp.sum`` sums it.  The
    reference's stop test ``L ||Y_n - Z|| <= 1e-8 (1 + ||Y_n||)`` asks for
    less than float32's epsilon; the port floors its tolerance at
    ``STOP_TOL_EPS`` epsilons (``hallar/solver.py``), without which its one
    inner solve ran 2,922 steps here and 10,000 (the cap) on other orders of
    C's entries.  The port's solve stops within 2x of JAX's steps (231
    against 132 on the CPU), the objectives agree to 1e-6 relative, and
    both to 1e-6 of the float64 optimum."""
    (pt, lam), (pj, _) = min_eig_problem(TS), min_eig_problem(JS)
    jax_steps = counting_jax_steps(monkeypatch)
    got, ref = solve_both(pt, pj, eps_gap=1e-4, maxiter_hallar=200,
                          lanczos_iters=24, dtype="float32")
    assert got.Y.dtype == np.float32 and got.p.dtype == np.float32
    print("f32", rel(got.pobj, ref.pobj), rel(got.dval, ref.dval),
          got.fista_steps, jax_steps)
    assert got.iters == 1 and len(jax_steps) == 1
    assert jax_steps[0] / 2 <= got.fista_steps <= 2 * jax_steps[0]
    assert rel(got.pobj, ref.pobj) <= 1e-6
    assert rel(got.dval, ref.dval) <= 1e-6
    assert rel(got.pobj, lam) <= 1e-6 and rel(ref.pobj, lam) <= 1e-6


def reference_spread():
    """The evidence for the bounds above, printed: the JAX solve against
    itself from Y0 and from Y0 (1 + eps) (5-cycle at 1e-15; the 200-node
    MaxCut at 1e-15 and 1e-13), and the first inner solve of that MaxCut in
    both packages from the same Y0 (max |Y_port - Y_jax| after k steps, and
    the step at which each stops within 8,300)."""
    from ltr_lowrank_sdp_tpu.testing import random_maxcut_problem

    def rng_y0(n, r, tau):
        y0 = np.random.default_rng(0).normal(size=(n, r))
        return y0 * (np.sqrt(tau) / np.linalg.norm(y0))

    cases = [("5-cycle", JS.build_mss_problem(C5, 5),
              JS.HallarParams(**C5_PARAMS), (1e-15,)),
             ("maxcut200", JS.SpectraplexProblem.from_sdp_problem(
                 random_maxcut_problem(200), 200.0), JS.HallarParams(),
              (1e-15, 1e-13))]
    for name, prob, params, epss in cases:
        y0 = rng_y0(prob.n, params.init_rank, prob.tau)
        r0 = JS.hallar_solve(prob, params, Y0=y0)
        for eps in epss:
            r1 = JS.hallar_solve(prob, params, Y0=y0 * (1 + eps))
            print(f"{name} Y0 (1 + {eps:g}): iters {r1.iters} rank "
                  f"{r1.final_rank}, pobj {rel(r1.pobj, r0.pobj):.2e}, dval "
                  f"{rel(r1.dval, r0.dval):.2e}, max |dY| "
                  f"{np.abs(r1.Y - r0.Y).max():.2e}, X {x_err(r1, r0):.2e}")
    prob = cases[1][1]
    jops = JS._Ops(prob, jnp.float64)
    tops = TS._Ops(TS.SpectraplexProblem(**{
        f: getattr(prob, f) for f in prob.__dataclass_fields__}),
        torch.float64, "cpu")
    y0 = rng_y0(200, 2, 200.0)
    for k in (100, 3000, 7900, 8300):
        Yj, _, kj = jax.jit(JS._make_fista(jops, JS.HallarParams(
            maxiter_fista=k)))(jnp.asarray(y0), jnp.zeros(200),
                               jnp.asarray(10.0), 1.0)
        Yt, _, kt = TS.fista(tops, TS.HallarParams(maxiter_fista=k),
                             torch.tensor(y0),
                             torch.zeros(200, dtype=torch.float64), 10.0,
                             1.0, TS._Counters())
        print(f"maxcut200 first inner solve, maxiter {k}: steps JAX "
              f"{int(kj)}, port {kt}; max |Y_port - Y_jax| "
              f"{np.abs(np.asarray(Yj) - Yt.numpy()).max():.2e}")


def float32_stop_evidence(max_steps=600):
    """The evidence for the float32 min-eig bound above, printed: the first
    inner solve of that case stepped in both packages from the same Y0, L0,
    p and beta (the port's machine steps grouped into FISTA steps), with
    <C, YY^T> summed as the port sums it (float32, K4's order), by
    ``torch.sum`` in float32, in float64, and in other float32 orders of its
    terms: the first step where Y or fz part, the
    first where L or the accept bit parts, the failed backtracking tests in
    JAX's steps, L at JAX's last step and the step at which each stops."""
    (pt, _), (pj, _) = min_eig_problem(TS), min_eig_problem(JS)
    kw = dict(eps_gap=1e-4, maxiter_hallar=200, lanczos_iters=24,
              dtype="float32")
    first = {}
    orig = TS.fista

    def record(ops, params, Y0, p, beta, L0, counters):
        first.setdefault("args", (Y0.clone(), p.clone(), beta, L0))
        return orig(ops, params, Y0, p, beta, L0, counters)

    TS.fista = record
    try:
        TS.hallar_solve(pt, TS.HallarParams(**kw), device="cpu",
                        lanczos_start=jax_start("float32"))
    finally:
        TS.fista = orig
    Y0, p, beta, L0 = first["args"]
    jops, jp = JS._Ops(pj, jnp.float32), JS.HallarParams(**kw)

    def al(Y):
        resid = jops.AX(Y) - jops.b
        val = (jops.CX(Y) + jnp.vdot(p.numpy(), resid)
               + 0.5 * beta * jnp.vdot(resid, resid))
        return val, 2.0 * jops.SY(p.numpy() + beta * resid, Y)

    @jax.jit
    def jax_step(Y, Z, tk, L):       # _make_fista's body, counting bt
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
                jnp.maximum(L / jp.L_inc_fista, jp.L0_fista), done, L, n_bt,
                fz)

    Y = Z = jnp.asarray(Y0.numpy())
    tk, L, ref = jnp.float32(1.0), jnp.float32(L0), []
    while len(ref) < max_steps:
        Y, Z, tk, L, done, L_used, n_bt, fz = jax_step(Y, Z, tk, L)
        ref.append((float(L_used), int(n_bt), np.asarray(Y), float(fz)))
        if done:
            break

    def terms(self, Yt):
        return self.c_dbl * torch.sum(Yt[self.c_rows.long()]
                                      * Yt[self.c_cols.long()], dim=-1)

    def strided(w):
        def cx(self, Yt):
            t = terms(self, Yt)
            acc = torch.cat([t, t.new_zeros(-t.numel() % w)]).view(
                -1, w).cumsum(0)[-1]
            while acc.numel() > 1:
                acc = acc[:acc.numel() // 2] + acc[acc.numel() // 2:]
            return acc[0]
        return cx

    orders = {"port (float32 sum, K4's order)": TS._Ops.CX,
              "torch.sum in float32": lambda self, Yt: torch.sum(
                  terms(self, Yt)),
              "float64 sum": lambda self, Yt: torch.sum(
                  terms(self, Yt).double()).float(),
              "sequential": lambda self, Yt: torch.cumsum(
                  terms(self, Yt), 0)[-1],
              "16 strided sums": strided(16), "32 strided sums": strided(32)}
    params = TS.HallarParams(**kw)
    try:
        for name, cx in orders.items():
            TS._Ops.CX = cx
            ops = TS._Ops(pt, torch.float32, "cpu")
            val, val_grad = TS.al_functions(ops, p, beta)
            st, got, n_bt = TS.fista_init(Y0, L0, val_grad), [], 0
            while not bool(st.done) and int(st.k) < params.maxiter_fista:
                L_before, k_before = float(st.L), int(st.k)
                fz = float(st.fz)
                st = TS._machine_step(st, ops, params, val, val_grad)
                if int(st.k) > k_before:
                    got.append((L_before, n_bt, st.Y.numpy().copy(), fz))
                    n_bt = 0
                else:
                    n_bt += 1
            pair = list(zip(ref, got))
            bits = next((k for k, (a, b) in enumerate(pair)
                         if a[3] != b[3] or not np.array_equal(a[2], b[2])),
                        None)
            ctrl = next((k for k, (a, b) in enumerate(pair)
                         if a[:2] != b[:2]), None)
            print(f"float32 min-eig, first inner solve, <C, X> by {name}: "
                  f"steps JAX {len(ref)}, port {len(got)}; Y or fz part at "
                  f"step {bits}, L or the accept bit at step {ctrl}; failed "
                  f"tests in JAX's steps: JAX {sum(r[1] for r in ref)}, "
                  f"port {sum(g[1] for g in got[:len(ref)])}; L at JAX's "
                  f"last step: JAX {ref[-1][0]:g}, port "
                  f"{got[min(len(ref), len(got)) - 1][0]:g}")
    finally:
        TS._Ops.CX = orders["port (float32 sum, K4's order)"]


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_hallar_solve.py (a few minutes)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    float32_stop_evidence()
    reference_spread()
