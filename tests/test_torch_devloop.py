"""The device-resident ALM and ADMM loops (``solver/devloop.py``) against the
eager ones.

Each loop is one body of device tensors run under a flow: on the card a
CUDA graph whose conditional nodes take the decisions, on the CPU the host
flow, which reads each predicate.  On the CPU, bit for bit:

* the device CG step loop (``cg_device``) against ``cg_solve``, in float64
  and float32, and a stagnating float32 system that returns its best
  iterate;
* the masked L-BFGS recursion (``direction_t`` / ``push_pair_t``) against
  the host-pointer one, across a ring wrap, a ``clear`` reset and a
  rejected pair;
* ``quartic_argmin_t(tau_max)`` against the JAX package's
  ``quartic_linesearch`` on seeded coefficients (``root_num == 0``
  included), and ``quartic_step`` on the CPU against ``quartic_argmin``;
* one ADMM loop (``loop_device`` against ``loop_eager``) and ALM inner
  passes (``_inner_pass_device`` against ``_inner_pass_eager``) from one
  carry: every carry tensor, the control state, every stats row and Gram;
* whole solves with the device loops against the eager loops (those of a
  sharded solve): status, counts, objectives, factors and duals, every ALM
  and ADMM stats row and Gram, and the trajectory JSON, on an LP cone and
  several blocks (a reopt round), the Jacobi sweep, theta (a reopt round),
  and float32 with the host float64 re-check and the precision-plateau
  exit; the device loops read the host fewer times.

``tests/test_torch_devloop_card.py`` holds the graphs on the card to the
eager loops there.
"""

import dataclasses
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.ops import cubic as jax_cubic
from ltr_lowrank_sdp_torch.config import SolverParams
from ltr_lowrank_sdp_torch.ops import cubic
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.ops import lbfgs
from ltr_lowrank_sdp_torch.ops.cg import cg_device, cg_solve
from ltr_lowrank_sdp_torch.problem import load_problem
from ltr_lowrank_sdp_torch.solver import admm as admm_mod
from ltr_lowrank_sdp_torch.solver import alm as alm_mod
from ltr_lowrank_sdp_torch.solver.common import HostSync, init_factors
from ltr_lowrank_sdp_torch.solver import devloop
from ltr_lowrank_sdp_torch.solver.devloop import HostFlow
from ltr_lowrank_sdp_torch.solver.driver import Solver
from ltr_lowrank_sdp_torch.solver.logging import TrajectoryLogger
from ltr_lowrank_sdp_torch.solver.rank import make_rank_state
from ltr_lowrank_sdp_torch.testing import (matcomp_sdpa, multiblock_lp_sdpa,
                                           random_maxcut_problem, theta_sdpa,
                                           write_sdpa)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's OpenMP workers spin after each parallel op and starve XLA's
    CPU threads in the same process; the sizes here need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# CG
# --------------------------------------------------------------------------- #


def _spd(n, cond, seed, dtype):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.geomspace(1.0, cond, n)
    A = torch.tensor((Q * ev) @ Q.T, dtype=dtype)
    b = torch.tensor(rng.standard_normal((n, 2)), dtype=dtype)
    x0 = torch.tensor(0.1 * rng.standard_normal((n, 2)), dtype=dtype)
    return (lambda x: A @ x), b, x0


@pytest.mark.parametrize("dtype,cond,tol,max_iter", [
    (torch.float64, 1e3, 1e-10, 300),
    (torch.float64, 1e6, 1e-12, 60),        # stops at max_iter
    (torch.float32, 1e2, 1e-5, 300),
    (torch.float32, 1e6, 1e-12, 800),       # stagnates: the best iterate
])
def test_device_cg_gives_the_eager_bits(dtype, cond, tol, max_iter):
    mv, b, x0 = _spd(40, cond, 3, dtype)
    want = cg_solve(mv, b, x0, tol, max_iter, 20)
    x, k = cg_device(HostFlow, mv, b, x0,
                     torch.tensor(tol, dtype=torch.float64), max_iter, 20)
    assert int(k) == want.iters
    assert torch.equal(x, want.x)
    if dtype == torch.float32 and cond > 1e3:
        # the float32 guard stopped it, with its best iterate
        assert not want.converged and want.iters < max_iter
        r = torch.linalg.vector_norm(b - mv(x)) / b.abs().sum()
        assert float(r) <= 2 * want.resid


# --------------------------------------------------------------------------- #
# L-BFGS
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("length", [1, 2, 3])
def test_masked_lbfgs_gives_the_host_pointer_bits(length):
    """Pushes past a ring wrap (a rejected pair among them), the direction
    at every n_valid (the ``clear`` reset passes 0) after each push."""
    rng = np.random.default_rng(length)
    n = 30
    host = lbfgs.init_history(n, length, "cpu")
    dev = lbfgs.init_history(n, length, "cpu")
    ring = lbfgs.DeviceRing(torch.tensor(0), torch.tensor(0))
    for step in range(2 * length + 3):
        g = torch.tensor(rng.standard_normal(n))
        for n_valid in range(length + 2):
            want = lbfgs.direction(host, g, n_valid=n_valid)
            got = lbfgs.direction_t(dev, ring, g, torch.tensor(n_valid))
            assert torch.equal(got, want), (step, n_valid)
        s = torch.tensor(rng.standard_normal(n))
        y = -s if step == 2 else s + 0.3 * torch.tensor(
            rng.standard_normal(n))          # step 2: a rejected pair
        lbfgs.push_pair(host, s, y)
        lbfgs.push_pair_t(dev, ring, s, y)
        assert (int(ring.head), int(ring.count)) == (host.head, host.count)
        assert torch.equal(dev.s, host.s) and torch.equal(dev.y, host.y)
        assert torch.equal(dev.beta, host.beta)
    assert float(host.beta.min()) >= 0.0


# --------------------------------------------------------------------------- #
# the line search
# --------------------------------------------------------------------------- #


def _ls_inputs(seed, m=20):
    rng = np.random.default_rng(seed)
    q0, q1, q2, lam = (rng.standard_normal(m) for _ in range(4))
    rho = float(10.0 ** rng.uniform(-2, 2))
    p1, p2 = rng.standard_normal(2) * 10.0 ** rng.uniform(-2, 2, 2)
    tau_max = float(rng.uniform(0.2, 3.0))
    if seed % 5 == 0:
        q1 = np.zeros(m)                 # no linear term from A
    if seed % 7 == 0:
        lam = np.full(m, np.nan)         # degenerate: root_num == 0
    return rho, lam, p1, p2, q0, q1, q2, tau_max


@pytest.mark.parametrize("seed", range(24))
def test_device_line_search_matches_jax(seed):
    rho, lam, p1, p2, q0, q1, q2, tau_max = _ls_inputs(seed)
    jt, jn = jax_cubic.quartic_linesearch(
        rho, jnp.asarray(lam), p1, p2, jnp.asarray(q0), jnp.asarray(q1),
        jnp.asarray(q2), tau_max=tau_max)
    t = [torch.tensor(v) for v in (lam, q0, q1, q2)]
    coef = cubic.quartic_coeffs(torch.tensor(rho, dtype=torch.float64),
                                t[0], torch.tensor(p1), torch.tensor(p2),
                                *t[1:])
    tau, root_num = cubic.quartic_argmin_t(
        *coef, tau_max=torch.tensor(tau_max, dtype=torch.float64))
    assert int(root_num) == int(jn)
    if int(jn) == 0:
        assert seed % 7 == 0
    np.testing.assert_allclose(float(tau), float(jt), rtol=1e-9, atol=1e-14)
    # the CPU's step is the host float64 search, bit for bit
    st, sn = cubic.quartic_step(coef, torch.tensor(tau_max,
                                                   dtype=torch.float64))
    ht, hn = cubic.quartic_argmin(*coef.tolist(), tau_max=tau_max)
    assert (float(st), int(sn)) == (ht, hn) or (math.isnan(ht)
                                                and math.isnan(float(st)))


def test_device_line_search_takes_a_batch():
    """``tau_max`` as a tensor per quartic, as a float: the same steps."""
    rng = np.random.default_rng(5)
    a, b, c, d = (torch.tensor(rng.standard_normal(64)) for _ in range(4))
    tm = torch.tensor(rng.uniform(0.5, 2.0, 64))
    taus, nums = cubic.quartic_argmin_t(a, b, c, d, tau_max=tm)
    for i in range(0, 64, 9):
        t1, n1 = cubic.quartic_argmin_t(a[i], b[i], c[i], d[i],
                                        tau_max=float(tm[i]))
        assert (float(t1), int(n1)) == (float(taus[i]), int(nums[i]))
    ones, _ = cubic.quartic_argmin_t(a, b, c, d)
    assert bool((ones <= 1.0).all()) and bool((taus <= tm).all())


# --------------------------------------------------------------------------- #
# one loop from one carry
# --------------------------------------------------------------------------- #


def _tensors_equal(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_tensors_equal(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b)


def _mblp(tmp_path):
    path = tmp_path / "mblp.dat-s"
    write_sdpa(path, multiblock_lp_sdpa((14, 12, 10), 40, 60, seed=1))
    return load_problem(str(path))


def _phase_start(prob, params):
    """A solver, its phases at the starting ranks, and a prepared ALM
    carry from the seeded factors."""
    sv = Solver(prob, params, device="cpu")
    ranks = make_rank_state(prob, params).ranks
    alm, admm = sv._new_phases(ranks, HostSync())
    g = torch.Generator().manual_seed(int(params.seed))
    R, rlp = init_factors(ranks, prob.block_dims, prob.n_lp_cols, g, "cpu",
                          sv.dtype)
    rho0 = 1.0 / np.sqrt(sum(prob.block_dims))
    carry = alm_mod.make_alm_carry(R, prob.m, alm.n_elems, rho0, params,
                                   rlp=rlp)
    return sv, alm, admm, alm.prepare(carry)


def _copy_hist(c):
    h = c.hist
    return c.replace(hist=lbfgs.LBFGSHistory(h.s.clone(), h.y.clone(),
                                             h.beta.clone(), h.head, h.count))


@pytest.mark.parametrize("kind", ["maxcut", "mblp", "maxcut-f32"])
def test_alm_passes_give_the_eager_bits(kind, tmp_path):
    """Inner passes from one carry, main and reopt variants, the float32
    floor flag: the carry, the ring, the pass statistics."""
    if kind == "mblp":
        prob, params = _mblp(tmp_path), SolverParams()
    else:
        prob = random_maxcut_problem(48, avg_degree=5, seed=7)
        params = SolverParams(phase1_tol=0.1, dtype=(
            "float32" if kind.endswith("f32") else "float64"))
    _, alm, _, carry = _phase_start(prob, params)
    ctrl = alm_mod.make_outer_ctrl(params, 1, 1, params.alm_rho_factor)
    for k in range(6):
        early_variant, p1_floor = k % 3 == 2, k % 2 == 1
        a, sa = alm._inner_pass_eager(_copy_hist(carry), early_variant,
                                      p1_floor)
        b, sb = alm._inner_pass_device(_copy_hist(carry), early_variant,
                                       p1_floor)
        assert sa == sb and sa.local_iter > 0
        for f in ("R", "rlp", "dual", "constr_sum", "CR", "grad", "grad_lp"):
            assert _tensors_equal(getattr(a, f), getattr(b, f)), f
        for f in ("cert_val", "pinf_l1", "pinf_inf"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.hist.head, a.hist.count) == (b.hist.head, b.hist.count)
        assert _tensors_equal([a.hist.s, a.hist.y, a.hist.beta],
                              [b.hist.s, b.hist.y, b.hist.beta])
        carry = alm._update_rho(a, ctrl)


@pytest.mark.parametrize("kind", ["mblp-grams", "maxcut-f32-check"])
def test_admm_loop_gives_the_eager_bits(kind, tmp_path):
    """The main ADMM loop from the handoff of a short ALM run, its first
    chunk end at iteration 10, to a ceiling past the next: every carry
    tensor, the control state, every stats row and Gram, the float64
    re-check's calls."""
    if kind == "mblp-grams":
        prob, params = _mblp(tmp_path), SolverParams(phase1_tol=1.0)
    else:
        prob = random_maxcut_problem(48, avg_degree=5, seed=7)
        params = SolverParams(phase1_tol=0.1, dtype="float32",
                              phase2_tol=3e-8)
    sv, alm, admm, carry = _phase_start(prob, params)
    ctrl = alm_mod.make_outer_ctrl(params, 1, 1, params.alm_rho_factor)
    for _ in range(2):
        carry = alm.outer_step(carry, ctrl, mode="main", early_stop=False,
                               is_rank_max=True, rank_thresh=1e8,
                               max_alm_iter=200)
    want_grams = kind == "mblp-grams"
    out = {}
    for loop in ("loop_eager", "loop_device"):
        rows, checks = [], []

        def f64_check(c):
            checks.append(int(len(rows)))
            return (1.0, 1.0, 1.0, 1.0, 1.0)      # never converged

        a = admm.blank_carry(
            carry.R, tuple(r.clone() for r in carry.R), carry.dual, 1.0,
            carry.rlp, None if carry.rlp is None else carry.rlp.clone())
        a = admm.metrics(a).replace(pinf_l1=carry.pinf_l1,
                                    pinf_inf=carry.pinf_inf, gap=carry.gap)
        actrl = admm.make_ctrl(carry.rho * 10.0, params.rho_max, 0)
        info = admm_mod.ADMMInfo()
        res = getattr(admm, loop)(
            a, actrl, mode="main", iter_ceiling=160, time_start=time.time(),
            info=info, want_grams=want_grams,
            record_cb=lambda row, grams, it: rows.append(
                (it, list(row), [g.copy() for g in grams])),
            f64_check=None if want_grams else f64_check,
            chunk_from=10)
        out[loop] = (res, dataclasses.asdict(actrl), info, rows, checks)
    (ea, ec, ei, er, ek), (da, dc, di, dr, dk) = (out["loop_eager"],
                                                  out["loop_device"])
    assert len(er) > 10 and ec == dc and ei == di
    assert ek == dk
    for f in ("U", "V", "dual", "constr_val", "constr_sum", "CV", "ulp",
              "vlp", "constr_lp"):
        assert _tensors_equal(getattr(ea, f), getattr(da, f)), f
    for f in ("pobj", "dobj", "pinf_l1", "pinf_inf", "gap"):
        assert getattr(ea, f) == getattr(da, f), f
    assert len(er) == len(dr)
    for (it1, r1, g1), (it2, r2, g2) in zip(er, dr):
        assert it1 == it2 and r1 == r2
        assert len(g1) == len(g2) and all(np.array_equal(x, y)
                                          for x, y in zip(g1, g2))
    if want_grams:
        assert all(len(g) == len(prob.cones) for _, _, g in dr)


# --------------------------------------------------------------------------- #
# whole solves
# --------------------------------------------------------------------------- #


class _RowLogger(TrajectoryLogger):
    """Keeps every ALM and ADMM stats row with its Grams."""

    def __init__(self, params):
        super().__init__(params, verbose=False)
        self.rows = []

    def record_alm_row(self, stat_row, outer_iter, inner_iter, grams,
                       curr_rank, phase_time):
        self.rows.append(("alm", outer_iter, inner_iter, list(stat_row),
                          [np.asarray(g).copy() for g in grams]))
        super().record_alm_row(stat_row, outer_iter, inner_iter, grams,
                               curr_rank, phase_time)

    def record_admm_row(self, stat_row, grams, it, curr_rank, nblk,
                        phase_time):
        self.rows.append(("admm", it, None, list(stat_row),
                          [np.asarray(g).copy() for g in grams]))
        super().record_admm_row(stat_row, grams, it, curr_rank, nblk,
                                phase_time)


def _solve_case(kind, tmp_path):
    if kind.startswith("mblp"):
        return _mblp(tmp_path), SolverParams(
            admm_jacobi=kind.endswith("jacobi"))
    if kind == "theta":
        path = tmp_path / "theta.dat-s"
        write_sdpa(path, theta_sdpa(20, 5, 20))
        return load_problem(str(path)), SolverParams()
    if kind == "matcomp-f32":
        path = tmp_path / "mc.dat-s"
        write_sdpa(path, matcomp_sdpa(30, 30, 2, 1.0, 0))
        return load_problem(str(path)), SolverParams(
            dtype="float32", heuristic_factor=10.0, host_f64_verify=True)
    prob = random_maxcut_problem(48, avg_degree=5, seed=7)
    if kind == "maxcut":
        return prob, SolverParams(phase1_tol=0.1)
    if kind == "maxcut-f32-check":
        # the float64 re-check ends the main ADMM loop
        return prob, SolverParams(dtype="float32", phase2_tol=3e-8,
                                  host_f64_verify=True)
    # "maxcut-f32-plateau": the precision plateau ends it at iteration 550
    return prob, SolverParams(dtype="float32", phase2_tol=1e-8,
                              disable_oracle=True, reopt_level=0,
                              max_admm_iter=600)


@pytest.mark.parametrize("kind", ["maxcut", "mblp", "mblp-jacobi", "theta",
                                  "matcomp-f32", "maxcut-f32-check",
                                  "maxcut-f32-plateau"])
def test_solve_with_device_loops_gives_the_eager_bits(kind, tmp_path):
    prob, params = _solve_case(kind, tmp_path)
    out = {}
    for device_loops in (False, True):
        sv = Solver(prob, params, device="cpu")
        sv.device_loops = device_loops
        logger = _RowLogger(params)
        path = tmp_path / f"{kind}-{device_loops}.json"
        K.reset_counts()
        res = sv.solve(logger=logger, json_path=str(path))
        traj = json.loads(path.read_text())
        traj["metrics"].pop("solve_time_sec")
        out[device_loops] = (res, logger.rows, traj, K.counts())
    (e, erows, etraj, ecounts), (d, drows, dtraj, dcounts) = (out[False],
                                                              out[True])
    for f in ("status", "pobj", "dobj", "pinf_l1", "pinf_inf", "gap",
              "dinf_l1", "alm_outer_iters", "alm_inner_iters", "admm_iters",
              "cg_iters", "final_ranks", "oracle_rank", "polish_runs",
              "obj_scale"):
        assert getattr(e, f) == getattr(d, f), f
    for f in ("U", "V", "ulp", "vlp", "dual"):
        a, b = getattr(e, f), getattr(d, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert all(np.array_equal(x, y) for x, y in zip(
                a if isinstance(a, tuple) else (a,),
                b if isinstance(b, tuple) else (b,))), f
    assert len(erows) == len(drows) > 0
    for (k1, i1, j1, r1, g1), (k2, i2, j2, r2, g2) in zip(erows, drows):
        assert (k1, i1, j1, r1) == (k2, i2, j2, r2)
        assert all(np.array_equal(x, y) for x, y in zip(g1, g2))
    assert etraj == dtraj
    assert ecounts == dcounts        # the same plain calls, one by one
    assert 0 < d.host_syncs < e.host_syncs
    assert d.graph_replays == e.graph_replays == 0
    if kind == "maxcut-f32-plateau":
        assert d.polish_runs == 1 and d.admm_iters > 550


def test_phase_states_clone_apart(tmp_path):
    """The warm-up copies of a graph's static state (ALM pass and ADMM
    chunk) share no tensor with it."""
    prob, params = _mblp(tmp_path), SolverParams()
    _, alm, admm, carry = _phase_start(prob, params)
    S = alm._fill_pass_state(alm._new_pass_state(carry), carry)
    C = alm._clone_pass_state(S)
    assert C.hist.s is not S.hist.s and C.ring.head is not S.ring.head
    assert all(x is not y and torch.equal(x, y) for x, y in zip(C.R, S.R))
    a = admm.init_carry(carry.R, tuple(r.clone() for r in carry.R),
                        carry.dual, 1.0, carry.rlp, carry.rlp.clone())
    S2 = admm._fill_state(admm._new_state(True), a,
                          admm.make_ctrl(1.0, 10.0))
    C2 = admm._clone_state(S2)
    assert C2.grams.shape == S2.grams.shape and C2.buf is not S2.buf
    assert all(x is not y and torch.equal(x, y) for x, y in zip(C2.U, S2.U))


def test_graph_accounting_adds_body_runs_times_launches():
    """``DeviceGraph.account``: the top level's launches once a replay, each
    body's own launches times its runs, into ``counts()``,
    ``counts_f32()`` and K1's folds."""
    g = object.__new__(devloop.DeviceGraph)
    zero = {k: (0, 0, 0) for k in K.KERNELS}
    g.top = dict(zero, sym_contract_sum=(1, 0, 0))
    g.bodies = [dict(zero, spmm_sym_csr=(2, 2, 1)),     # a WHILE body
                None,                                   # launches nothing
                dict(zero, diag_rowdot=(1, 1, 0))]      # an IF inside it
    K.reset_counts()
    g.account([5, 3, 4])
    c, f32 = K.counts(), K.counts_f32()
    assert c["sym_contract_sum"] == (1, 0) and c["spmm_sym_csr"] == (10, 0)
    assert c["diag_rowdot"] == (4, 0) and f32["spmm_sym_csr"] == 10
    assert f32["diag_rowdot"] == 4 and K.KERNELS["spmm_sym_csr"].folds == 5
    g.account([0, 0, 0])
    assert K.counts()["spmm_sym_csr"] == (10, 0)
    assert K.counts()["sym_contract_sum"] == (2, 0)
    K.reset_counts()


def test_graphs_refuse_the_profiler():
    """No conditional-node graph is captured or replayed under
    ``torch.profiler`` (CUPTI faults on such replays on the card): the
    capture raises before it touches the device, with the reason."""
    from torch.profiler import ProfilerActivity, profile

    devloop.refuse_under_profiler("outside a session")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="torch.profiler is active"):
            devloop.DeviceGraph("probe", torch.device("cpu"), None, None,
                                None)
    devloop.refuse_under_profiler("after the session")


def _jax_theta_counts(n: int) -> None:
    """The JAX package's solve of ``theta_sdpa(n, n // 4, n)`` on the CPU in
    float64 (the reference for the card's ALM / ADMM / CG counts of
    ``chip_smoke.py``'s theta path): its counts, ranks and pobj."""
    import os
    import tempfile

    from ltr_lowrank_sdp_tpu.problem import load_problem as jax_load
    from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"theta{n}.dat-s")
        write_sdpa(path, theta_sdpa(n, n // 4, n))
        t = time.time()
        res = JaxSolver(jax_load(path)).solve()
    print(f"JAX package, CPU, theta_sdpa({n}, {n // 4}, {n}): "
          f"{res.status.value}, ALM outer {res.alm_outer_iters} inner "
          f"{res.alm_inner_iters}, ADMM {res.admm_iters}, CG {res.cg_iters}, "
          f"final ranks {res.final_ranks}, pobj {res.pobj!r}, "
          f"{time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    # python tests/test_torch_devloop.py theta N   (N = 300: ~3 min)
    import sys

    _jax_theta_counts(int(sys.argv[2]) if len(sys.argv) > 2 else 300)
