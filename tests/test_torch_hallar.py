"""The HALLaR slice of the port against the JAX package: the conic
operators ``_Ops.AX / CX / SY`` (K5, K4, K6 on CPU tensors: their plain
versions) and ``project``, the escape-step Lanczos, the device-resident FISTA
machine against the plain per-step loop it replaces, and the CLI twin."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ltr_lowrank_sdp_torch.hallar import cli as tcli
from ltr_lowrank_sdp_torch.hallar import solver as TS
from ltr_lowrank_sdp_torch.ops.lanczos import lanczos_min_eig_vec
from ltr_lowrank_sdp_torch.testing import (matcomp_nuclear_norm, matcomp_sdpa,
                                           write_sdpa)
from ltr_lowrank_sdp_tpu.hallar import cli as jcli
from ltr_lowrank_sdp_tpu.hallar import solver as JS
from ltr_lowrank_sdp_tpu.ops.lanczos import lanczos_min_eig_vec as jax_lanczos

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
    """(port problem, JAX problem) built from the same arrays."""
    if name == "mss_c5":
        t = TS.build_mss_problem(C5, 5)
    elif name == "mss_30":
        t = TS.build_mss_problem(_random_graph(30, 0.2, 1), 30)
    else:       # matrix completion, 20 x 20, rank 2, as the CLI reads it
        from ltr_lowrank_sdp_torch.problem import canonicalize

        t = TS.SpectraplexProblem.from_sdp_problem(
            canonicalize(matcomp_sdpa(20, 20, 2, 1.0, 0)),
            3 * matcomp_nuclear_norm(20, 20, 2, 0))
    j = JS.SpectraplexProblem(**{f: getattr(t, f) for f in (
        "n", "m", "b", "tau", "c_rows", "c_cols", "c_vals", "a_rows",
        "a_cols", "a_vals", "a_cid")})
    return t, j


PROBLEMS = ("mss_c5", "mss_30", "matcomp")


@pytest.mark.parametrize("dtype, tol", [("float64", 1e-12),
                                        ("float32", 2e-6)])
@pytest.mark.parametrize("name", PROBLEMS)
def test_ops_match_the_jax_ops(name, dtype, tol):
    """AX, CX, SY (at the solve's rank and at r = 1, the Lanczos matvec) and
    project; float32 CX is K4's float64 sum rounded, JAX's a float32 sum."""
    pt, pj = _problem(name)
    rng = np.random.default_rng(3)
    ops = TS._Ops(pt, TS._DTYPES[dtype], "cpu")
    jops = JS._Ops(pj, jnp.dtype(dtype))
    for r in (4, 1):
        Y = rng.normal(size=(pt.n, r)).astype(dtype)
        w = rng.normal(size=pt.m).astype(dtype)
        Yt, wt = torch.tensor(Y), torch.tensor(w)
        Yj, wj = jnp.asarray(Y), jnp.asarray(w)
        pairs = [(ops.AX(Yt), jops.AX(Yj)), (ops.CX(Yt), jops.CX(Yj)),
                 (ops.SY(wt, Yt), jops.SY(wj, Yj)),
                 (ops.project(Yt), jops.project(Yj)),
                 (ops.project(1e-3 * Yt), jops.project(1e-3 * Yj))]
        for a, b in pairs:
            assert a.dtype == TS._DTYPES[dtype]
            a, b = a.numpy(), np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * np.abs(b).max())


@pytest.mark.parametrize("name, iters", [("mss_30", 40), ("matcomp", 80),
                                         ("mss_c5", 5)])
def test_lanczos_min_eig_vec_matches_the_jax_function(name, iters):
    """The same start vector through both: lambda to 1e-12 and the Ritz
    vector to 1e-10 (``iters`` >= n at the 5-cycle: the basis fills)."""
    pt, pj = _problem(name)
    ops = TS._Ops(pt, torch.float64, "cpu")
    jops = JS._Ops(pj, jnp.float64)
    w = np.random.default_rng(5).normal(size=pt.m)
    key = jax.random.PRNGKey(7)
    lam_j, vec_j = jax_lanczos(
        lambda v: jops.SY(jnp.asarray(w), v[:, None])[:, 0], pt.n, key,
        num_iters=iters)
    v0 = torch.tensor(np.asarray(jax.random.normal(key, (pt.n,),
                                                   jnp.float64)))
    wt = torch.tensor(w)
    lam_t, vec_t = lanczos_min_eig_vec(
        lambda v: ops.SY(wt, v[:, None])[:, 0], pt.n, v0, iters)
    assert abs(lam_t - lam_j) <= 1e-12 * max(1.0, abs(lam_j))
    np.testing.assert_allclose(vec_t, vec_j, rtol=0, atol=1e-10)
    assert abs(np.linalg.norm(vec_t) - 1.0) < 1e-12


# --------------------------------------------------------------------------- #
# the chunked machine against the plain per-step loop
# --------------------------------------------------------------------------- #


def fista_per_step(ops, params, Y0, L0, val, val_grad):
    """The reference's loop (``_make_fista`` :216-253) step by step, in the
    port's arithmetic: the yardstick of the chunked machine.  Also returns
    the machine steps it takes (commits and L doublings)."""
    Y = Z = Y0
    tk = torch.ones((), dtype=Y0.dtype)
    L = torch.as_tensor(L0, dtype=Y0.dtype).clone()
    k, done, steps = 0, False, 0
    while not done and k < params.maxiter_fista:
        fz, gz = val_grad(Z)
        while True:
            Yn = ops.project(Z - gz / L)
            fy = val(Yn)
            diff = Yn - Z
            ub = fz + TS._vdot(gz, diff) + 0.5 * L * TS._vdot(diff, diff)
            steps += 1
            if not bool((fy > ub + 1e-12) & (L < 1e12)):
                break
            L = L * params.L_inc_fista
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        Zn = Yn + ((tk - 1.0) / tn) * (Yn - Y)
        crit = L * torch.linalg.vector_norm(Yn - Z)
        done = bool(crit <= params.err_tol_fista
                    * (1.0 + torch.linalg.vector_norm(Yn)))
        Y, Z, tk = Yn, Zn, tn
        L = torch.clamp(L / params.L_inc_fista, min=params.L0_fista)
        k += 1
    return Y, L, k, steps


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("name, subproblem, err_tol, steps", [
    ("mss_c5", "al", 1e-8, 150),   # runs to maxiter_fista
    ("matcomp", "al", 1e-8, 150),
    ("mss_c5", "al", 1e-4, 94),    # stops by the stationarity test
    ("mss_30", "prox", 1e-8, 150),
])
def test_chunked_machine_reproduces_the_per_step_loop(name, subproblem,
                                                      err_tol, steps, chunk):
    """Bit for bit: the same iterate, L and step count; the host reads
    (done, k) once per chunk until the chunk in which the loop stopped."""
    pt, _ = _problem(name)
    ops = TS._Ops(pt, torch.float64, "cpu")
    params = TS.HallarParams(maxiter_fista=150, err_tol_fista=err_tol)
    rng = np.random.default_rng(11)
    Y0 = ops.project(torch.tensor(rng.normal(size=(pt.n, 3))))
    p = torch.tensor(rng.normal(size=pt.m))
    if subproblem == "al":
        val, val_grad = TS.al_functions(ops, p, 10.0)
    else:
        val, val_grad = TS.prox_functions(ops, p, 10.0, Y0, 0.5)
    L0 = torch.tensor(3.0, dtype=torch.float64)
    counters = TS._Counters()
    Ym, Lm, km = TS.run_fista(ops, params, Y0, L0, val, val_grad, counters,
                              chunk=chunk)
    Yp, Lp, kp, machine_steps = fista_per_step(ops, params, Y0, L0, val,
                                               val_grad)
    assert km == kp == steps
    assert torch.equal(Ym, Yp) and torch.equal(Lm, Lp)
    assert counters.reads == -(-machine_steps // chunk)
    assert counters.replays == 0      # CUDA graphs only on the GPU


# --------------------------------------------------------------------------- #
# the CLI twin
# --------------------------------------------------------------------------- #


def test_cli_matches_the_jax_cli(tmp_path, capsys):
    """``-i file.dat-s --trace_bound t -c options.cfg -o out.json`` on a small
    matrix completion, against the JAX CLI with the same arguments."""
    path = tmp_path / "mc.dat-s"
    write_sdpa(path, matcomp_sdpa(40, 40, 3, 3.0, 0))
    tau = 3 * matcomp_nuclear_norm(40, 40, 3, 0)
    cfg = tmp_path / "options.cfg"
    cfg.write_text("# inner steps per outer iteration\nmaxiter_fista = 300\n"
                   "unknown_key = 1\n")
    args = ["-i", str(path), "--trace_bound", repr(tau), "-c", str(cfg)]
    assert jcli.main(args + ["-o", str(tmp_path / "j.json")]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "t.json"),
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "status: optimal" in out
    ref = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    for key in ("iters", "final_rank", "converged"):
        assert got[key] == ref[key], key
    assert got["converged"] and got["device"] == "cpu"
    assert got["fista_steps"] == 300 * got["iters"]
    assert abs(got["pobj"] - ref["pobj"]) <= 1e-8 * abs(ref["pobj"])
    # the optimum is the planted matrix's: trace 2 ||M||_*
    assert abs(got["pobj"] - 2 * tau / 3) <= 1e-4 * got["pobj"]


def test_cli_reads_hslr_and_rejects_sdpa_without_a_bound(tmp_path, capsys):
    from test_torch_hslr import HSLR_TEXT

    hslr = tmp_path / "p.hslr"
    hslr.write_text(HSLR_TEXT)
    cfg = tmp_path / "o.cfg"
    cfg.write_text("maxiter_fista = 50\nmaxiter_hallar = 2\n")
    out = tmp_path / "o.json"
    assert tcli.main(["-i", str(hslr), "-c", str(cfg), "-o", str(out),
                      "--device", "cpu", "--inner_solver", "aipp"]) == 0
    assert json.loads(out.read_text())["iters"] == 2
    sdpa = tmp_path / "mc.dat-s"
    write_sdpa(sdpa, matcomp_sdpa(10, 10, 2, 1.0, 0))
    with pytest.raises(SystemExit, match="trace_bound"):
        tcli.main(["-i", str(sdpa), "--device", "cpu"])


def test_options_file_maps_onto_params(tmp_path):
    cfg = tmp_path / "o.cfg"
    cfg.write_text("eps_gap = 1e-3\nerr_tol_eig = 1e-4\ntrace_bound = 7\n"
                   "inner_solver = aipp\n")
    params, tau = tcli.params_from_cfg(tcli.read_options_cfg(str(cfg)),
                                       maxiter_fista=9)
    ref, ref_tau = jcli.params_from_cfg(jcli.read_options_cfg(str(cfg)),
                                        maxiter_fista=9)
    assert tau == ref_tau == 7.0
    assert {f: getattr(params, f) for f in ref.__dataclass_fields__} == {
        f: getattr(ref, f) for f in ref.__dataclass_fields__}


def test_run_tests_prints_the_binary_success_lines(capsys):
    assert tcli.main(["--run_tests", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["Running tests", "[ Info: All HSLR tests passed ]",
                   "[ Info: All SDPA tests passed ]"]
