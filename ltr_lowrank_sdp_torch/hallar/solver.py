"""HALLaR-class spectraplex solver on PyTorch / CUDA.

The port of ``ltr_lowrank_sdp_tpu/hallar/solver.py``.  It solves

    min <C, X>   s.t.  A(X) = b,  tr(X) <= tau,  X >= 0

through the factorization X = YY^T with ||Y||_F^2 <= tau: an inexact
augmented Lagrangian outer loop whose subproblems are minimized by a monotone
projected FISTA with adaptive backtracking (ADAP-FISTA class) or its
prox-point wrapper (ADAP-AIPP), plus the escape step that appends the
minimum eigenvector of S = C + A*(p + beta (A(X) - b)) as a new column when
lambda_min(S) is negative enough.  The arithmetic and its order are the
reference's; see its docstring for the method's sources.

The conic operators of :class:`_Ops` run on the hand-written kernels of
:mod:`..ops.kernels`: A(YY^T) and <C, YY^T> together on K5
(``coo_contract_segsum``, U is V) over one layout of A and C, C's entries
the constraint m (:meth:`_Ops.axc`), and (C + A*(w)) Y on K6
(``spmm_constr_csr``) over another; on CPU tensors their plain versions
(<C, YY^T> there by K4's, ``sym_contract_sum``).

The reference runs the inner FISTA as one fused ``lax.while_loop`` per
dispatch.  Here it is a state machine on device tensors (:func:`_machine_step`):
one step evaluates the projected candidate at the current L and either
doubles L (the backtracking test failed) or commits the FISTA update and
evaluates the AL value and gradient at the new extrapolated point.  A step
is the loop body's kernels K14-K16 around K5 and K6: the candidate
(``fista_candidate``, one thread-block cluster), A(YY^T) and <C, YY^T> at
the candidate and at the extrapolated point (K5 twice), both values and
K6's weights at the extrapolated point (one ``al_value_pair``), K6, and the
commit (``fista_commit``, in place): 8 graph nodes where C is a long
segment of K5's layout.  So a chunk of ``FISTA_CHUNK`` steps runs with
no host read; the host reads ``done`` and ``k`` once per chunk.  A step past
``done`` or ``maxiter_fista`` leaves the state as it is, as the while loop
would have stopped there.  On the GPU a chunk is captured once per inner
solve as a CUDA graph and replayed (:func:`run_fista`).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import kernels as K
from ..ops.lanczos import lanczos_min_eig_vec

# machine steps between two host reads of the inner loop's (done, k)
FISTA_CHUNK = 64

# The inner stop test's tolerance is at least this many epsilons of the
# compute dtype (a deviation in float32 only: in float64 the floor, 8.9e-16,
# lies far below ``err_tol_fista``).  The reference's 1e-8 is below float32's
# epsilon, so its test ``L ||Y_n - Z|| <= tol (1 + ||Y_n||)`` can fire only
# when Y_n equals Z to the bit, which the rounding of one projected step
# rarely allows.  The JAX package's float32 solve gets there all the same
# because its compiled backtracking test fails on rounding: on the min-eig
# case, 115 of its 155 failed tests pass in exact arithmetic on the same
# float32 iterates (the port's evaluation fails 49 of them), so its L climbs
# to 2.7e8, gz / L drops below Z's last bit and Y_n = Z.  The port's test
# passes at the noise floor, L stays small, and without the floor its solve
# ran to ``maxiter_fista`` on some orders of C's entries.  Over 64 permuted
# orders, on which the JAX package stops after 38 to 1,265 steps (median
# 234), a floor of 1, 2, 4 or 8 epsilons stops the port after at most 4,726,
# 1,337, 827 or 546 steps (median 970, 292.5, 215.5, 153); 4 is the smallest
# that keeps every order within the JAX spread
# (``tests/test_torch_f32_faults.py`` prints these numbers).
STOP_TOL_EPS = 4.0

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class HallarParams:
    """Defaults follow the binary's option table (README:147-193)."""

    maxiter_hallar: int = 10000
    maxiter_fista: int = 10000
    eps_pfeas: float = 1e-5
    eps_gap: float = 1e-5
    beta0: float = 10.0
    beta_inc: float = 1.1
    beta_min: float = 10.0
    beta_max: float = 1e11
    L0_fista: float = 1.0
    L_inc_fista: float = 2.0
    err_tol_fista: float = 1e-8
    escape_tol: float = 1e-6
    max_rank: int = 0            # 0 -> ceil(sqrt(2 m)) + 1
    init_rank: int = 2
    time_limit: float = 3600.0
    lanczos_iters: int = 80
    dtype: str = "float64"
    # inner AL subproblem solver: "fista" (ADAP-FISTA, default) or "aipp"
    # (ADAP-AIPP: prox-point outer loop with lambda halving, each prox
    # subproblem solved by the same projected FISTA)
    inner_solver: str = "fista"
    aipp_lambda0: float = 1.0
    aipp_max_prox: int = 30
    aipp_rho: float = 1e-6       # prox-residual stop ||W_{j-1}-W_j||/lam


@dataclasses.dataclass
class SpectraplexProblem:
    """min <C,X> s.t. A(X) = b, tr X <= tau, X >= 0 (single block).

    C and the A_i are symmetric COO stacks (upper triangle), like the
    LoRADS-path cones.
    """

    n: int
    m: int
    b: np.ndarray
    tau: float
    c_rows: np.ndarray
    c_cols: np.ndarray
    c_vals: np.ndarray
    a_rows: np.ndarray
    a_cols: np.ndarray
    a_vals: np.ndarray
    a_cid: np.ndarray

    @staticmethod
    def from_hslr(path: str) -> "SpectraplexProblem":
        from ..io.hslr import read_hslr

        return SpectraplexProblem.from_hslr_data(read_hslr(path))

    @staticmethod
    def from_hslr_data(data, tau: Optional[float] = None
                       ) -> "SpectraplexProblem":
        """Build from an :class:`~..io.hslr.HSLRData` (read_hslr /
        read_hybrid_sdpa); ``tau`` overrides the file's trace bound (the
        hybrid SDPA variant carries none)."""
        rows, cols, vals, cid = [], [], [], []
        for i, M in enumerate(data.A):
            D = M.dense()
            r, c = np.nonzero(np.triu(D))
            rows.append(r)
            cols.append(c)
            vals.append(D[r, c])
            cid.append(np.full(r.size, i))
        Cd = data.C.dense()
        cr, cc = np.nonzero(np.triu(Cd))
        tau_eff = data.tau if tau is None else tau
        if not np.isfinite(tau_eff):
            raise ValueError("trace bound required (file carries none)")
        return SpectraplexProblem(
            n=data.n, m=data.m, b=data.b, tau=tau_eff,
            c_rows=cr.astype(np.int32), c_cols=cc.astype(np.int32),
            c_vals=Cd[cr, cc],
            a_rows=np.concatenate(rows).astype(np.int32),
            a_cols=np.concatenate(cols).astype(np.int32),
            a_vals=np.concatenate(vals),
            a_cid=np.concatenate(cid).astype(np.int32),
        )

    @staticmethod
    def from_sdp_problem(prob, tau: float) -> "SpectraplexProblem":
        """Adapt a single-block canonical SDPProblem + trace bound."""
        cone = prob.cones[0]
        return SpectraplexProblem(
            n=cone.n, m=prob.m, b=prob.b, tau=tau,
            c_rows=cone.c_rows, c_cols=cone.c_cols, c_vals=cone.c_vals,
            a_rows=cone.a_rows, a_cols=cone.a_cols, a_vals=cone.a_vals,
            a_cid=cone.a_cid,
        )


@dataclasses.dataclass
class HallarResult:
    Y: np.ndarray
    p: np.ndarray            # dual vector
    theta: float             # dual of the trace constraint
    pobj: float
    dval: float
    pinf: float
    rel_gap: float
    iters: int
    final_rank: int
    solve_time: float
    converged: bool
    fista_steps: int = 0     # inner FISTA steps over the whole solve
    host_reads: int = 0      # device -> host reads over the whole solve
    graph_replays: int = 0   # CUDA-graph replays of an inner-loop chunk
    # per kernel, its launches inside those replays (on top of its counter)
    graph_runs: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Ops:
    """The conic operators on the single spectraplex block.

    Layouts built once on the host: A's entries sorted by constraint for K5
    (whose ``coef`` is the reference's ``a_dbl``), C's entries with their
    doubled off-diagonal weights for K4, the same entries of A and C as one
    K5 layout of m + 1 constraints (C the last, ``coef`` its ``c_dbl``), and
    one symmetric CSR of A and C together for K6, C's entries as constraint
    ``m`` with weight 1, with its weight vector ``wbuf`` ([w, 1], written by
    K15)."""

    def __init__(self, prob: SpectraplexProblem, dtype: torch.dtype,
                 device):
        self.n = prob.n
        self.m = prob.m
        self.dtype = dtype
        self.device = torch.device(device)
        self.b = torch.tensor(prob.b, dtype=dtype, device=device)
        self.tau = float(prob.tau)
        self.sqrt_tau = math.sqrt(self.tau)
        self.a_seg = K.SegCOO.from_coo(prob.a_rows, prob.a_cols, prob.a_vals,
                                       prob.a_cid, prob.n, prob.m, device,
                                       dtype)
        cr = np.asarray(prob.c_rows, np.int64)
        cc = np.asarray(prob.c_cols, np.int64)
        cv = np.asarray(prob.c_vals, np.float64)
        self.c_rows = torch.tensor(cr, dtype=torch.int32, device=device)
        self.c_cols = torch.tensor(cc, dtype=torch.int32, device=device)
        self.c_dbl = torch.tensor(np.where(cr != cc, 2.0, 1.0) * cv,
                                  dtype=dtype, device=device)
        # A's entries and C's as constraint m
        union = (np.concatenate([np.asarray(prob.a_rows, np.int64), cr]),
                 np.concatenate([np.asarray(prob.a_cols, np.int64), cc]),
                 np.concatenate([np.asarray(prob.a_vals, np.float64), cv]),
                 np.concatenate([np.asarray(prob.a_cid, np.int64),
                                 np.full(cr.size, prob.m, np.int64)]))
        self.s_csr = K.ConstrCSR.from_upper_coo(*union, prob.n, prob.m + 1,
                                                device, dtype)
        self.ac_seg = K.SegCOO.from_coo(*union, prob.n, prob.m + 1, device,
                                        dtype)
        self.wbuf = torch.ones(prob.m + 1, dtype=dtype, device=device)
        self._one = torch.ones(1, dtype=dtype, device=device)

    def AX(self, Y: torch.Tensor) -> torch.Tensor:
        """A(YY^T), (m,): K5."""
        return K.coo_contract_segsum(self.a_seg, Y, Y)

    def CX(self, Y: torch.Tensor) -> torch.Tensor:
        """<C, YY^T> as a 0-dim tensor of the compute dtype: K4, summing in
        the compute dtype as the reference's ``jnp.sum`` does (float32 sums
        in a float32 solve)."""
        return K.sym_contract_sum(self.c_rows, self.c_cols, self.c_dbl, Y, Y,
                                  acc32=self.dtype == torch.float32)

    def axc(self, Y: torch.Tensor) -> torch.Tensor:
        """[A(YY^T), <C, YY^T>] (m + 1,): on the card one K5 launch on the
        union layout (C's sum in the compute dtype, as the reference's
        ``jnp.sum``), on the CPU the plain version, ``[AX(Y), CX(Y)]``
        (:func:`..ops.kernels.axc_plain`)."""
        if Y.is_cuda:
            return K.coo_contract_segsum(self.ac_seg, Y, Y)
        return torch.cat([self.AX(Y), self.CX(Y)[None]])

    def SY(self, w: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """(C + A*(w)) Y: K6 with the weights ``[w, 1]``."""
        return K.spmm_constr_csr(self.s_csr, torch.cat([w, self._one]), Y)

    def project(self, Y: torch.Tensor) -> torch.Tensor:
        """Project onto the Frobenius ball ||Y||_F <= sqrt(tau)."""
        return K.project_plain(Y, self.sqrt_tau)


_vdot = K._vdot


@dataclasses.dataclass
class Subproblem:
    """The inner FISTA's objective: the AL subproblem ``AL(Y; p, beta) =
    <C, YY^T> + <p, r> + beta/2 <r, r>``, r = A(YY^T) - b (reference
    ``al_val_grad`` :208-214), or with a prox centre W ADAP-AIPP's ``lam
    AL(Y) + 1/2 ||Y - W||^2`` (``prox_val_grad`` :277-284)."""

    ops: _Ops
    p: torch.Tensor
    beta: float
    W: Optional[torch.Tensor] = None
    lam: float = 1.0

    def _wsq(self, Y):
        if self.W is None:
            return None
        diff = Y - self.W
        return _vdot(diff, diff)

    def value(self, Y: torch.Tensor) -> torch.Tensor:
        ops = self.ops
        return K.al_value(ops.axc(Y), ops.b, self.p, self.beta, self.lam,
                          self._wsq(Y))

    def value_grad(self, Y: torch.Tensor):
        ops = self.ops
        v = K.al_value(ops.axc(Y), ops.b, self.p, self.beta, self.lam,
                       self._wsq(Y), weights=ops.wbuf)
        S = K.spmm_constr_csr(ops.s_csr, ops.wbuf, Y)
        if self.W is None:
            return v, 2.0 * S
        return v, self.lam * 2.0 * S + (Y - self.W)


def _subproblem(val_grad: Callable) -> Subproblem:
    sub = getattr(val_grad, "__self__", None)
    if not isinstance(sub, Subproblem):
        raise TypeError("the inner loop takes the functions of al_functions "
                        "or prox_functions")
    return sub


# --------------------------------------------------------------------------- #
# the inner loop: a device-resident state machine
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class FistaState:
    """The inner FISTA's state, all device tensors: the iterate Y, the
    extrapolated point Z, the momentum t, the step constant L, the committed
    steps k, the stop flag, and the objective value and gradient at Z."""

    Y: torch.Tensor
    Z: torch.Tensor
    tk: torch.Tensor
    L: torch.Tensor
    k: torch.Tensor
    done: torch.Tensor
    fz: torch.Tensor
    gz: torch.Tensor


def fista_init(Y0: torch.Tensor, L0, val_grad: Callable) -> FistaState:
    """The state at Y0.  On the card K16 updates the state in place, so Y
    and Z get buffers of their own there."""
    fz, gz = val_grad(Y0)
    Y, Z = (Y0.clone(), Y0.clone()) if Y0.is_cuda else (Y0, Y0)
    return FistaState(
        Y=Y, Z=Z, tk=torch.ones((), dtype=Y0.dtype, device=Y0.device),
        L=torch.as_tensor(L0, dtype=Y0.dtype, device=Y0.device).clone(),
        k=torch.zeros((), dtype=torch.int64, device=Y0.device),
        done=torch.zeros((), dtype=torch.bool, device=Y0.device),
        fz=fz, gz=gz)


def _machine_step(st: FistaState, ops: _Ops, params: HallarParams,
                  val: Callable, val_grad: Callable,
                  plain: bool = False) -> FistaState:
    """One step of the inner loop (reference ``_make_fista`` :220-247).

    The candidate ``project(Z - gz / L)`` (K14) is tested as the
    backtracking loop's condition tests it (:226-232), on its value.  A
    failed test multiplies L by ``L_inc_fista``; a passed one commits the
    FISTA update (:236-247) with the value and gradient at the new Z, which
    the reference evaluates at the top of its next iteration.  The step
    runs K14, K5 at the candidate and at the new Z, one K15 for both values
    and K6's weights (a programmatic dependent launch after the second K5),
    K6, and K16, which takes the decision and updates the state, in place
    on the card.  The value and gradient at the new Z are formed on a
    failed test too, as the reference forms them, so the counts stay the
    reference's.  Only the value is needed for the test, so the
    candidate's gradient is never formed.  The stop test's tolerance is
    floored at ``STOP_TOL_EPS`` epsilons of the dtype.  ``plain`` takes the
    plain versions on any device (the smoke run's plain step); K15's pair
    is there two plain value calls, the candidate's first."""
    sub = _subproblem(val_grad)
    W = sub.W
    if plain:
        candidate, values, commit = (K.fista_candidate_plain,
                                     K.al_value_pair_plain,
                                     K.fista_commit_plain)
        spmm = K.spmm_constr_csr_plain

        def axc(Y):
            return K.axc_plain(ops.a_seg, ops.c_rows, ops.c_cols, ops.c_dbl,
                               Y)
    else:
        candidate, values, commit = (K.fista_candidate, K.al_value_pair,
                                     K.fista_commit)
        spmm, axc = K.spmm_constr_csr, ops.axc
    Yc, Zn, sc = candidate(st.Z, st.gz, st.L, st.Y, st.tk, W, ops.sqrt_tau)
    prox = W is not None
    fy, fzn = values(axc(Yc), axc(Zn), ops.b, sub.p, sub.beta, sub.lam,
                     sc[K.SC_WY] if prox else None,
                     sc[K.SC_WZ] if prox else None, ops.wbuf)
    S = spmm(ops.s_csr, ops.wbuf, Zn)
    tol = max(params.err_tol_fista, STOP_TOL_EPS * torch.finfo(Yc.dtype).eps)
    Y, Z, gz, tk, L, k, done, fz = commit(
        st.Y, st.Z, st.gz, st.tk, st.L, st.k, st.done, st.fz, Yc, Zn, sc, fy,
        fzn, S, W, sub.lam, params.maxiter_fista, params.L_inc_fista,
        params.L0_fista, tol)
    return FistaState(Y=Y, Z=Z, tk=tk, L=L, k=k, done=done, fz=fz, gz=gz)


class _Counters:
    """What the solve counts on the host: its device -> host reads, its
    CUDA-graph replays, and per kernel the launches that ran inside those
    replays (a kernel's own counter sees a launch inside a graph once, at
    capture; ``graph_runs`` adds the replays' runs)."""

    def __init__(self):
        self.reads = 0
        self.replays = 0
        self.graph_runs: Dict[str, int] = {}

    def get(self, t: torch.Tensor) -> np.ndarray:
        self.reads += 1
        return t.cpu().numpy()


def _capture_chunk(st: FistaState, run_chunk: Callable, stream):
    """One chunk of machine steps captured as a CUDA graph whose replay
    advances ``st`` in place.  Returns (graph, st's static copy, the launches
    of each kernel in one replay)."""
    st = FistaState(**{f.name: getattr(st, f.name).clone()
                       for f in dataclasses.fields(st)})
    kernels = {**K.KERNELS, **K.LOOP_KERNELS}
    before = {name: k.launches for name, k in kernels.items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = run_chunk(st)
        for f in dataclasses.fields(st):
            dst, src = getattr(st, f.name), getattr(out, f.name)
            if dst is not src:
                dst.copy_(src)
    per_replay = {name: k.launches - before[name]
                  for name, k in kernels.items()
                  if k.launches > before[name]}
    return graph, st, per_replay


def run_fista(ops: _Ops, params: HallarParams, Y0: torch.Tensor, L0,
              val: Callable, val_grad: Callable, counters: _Counters,
              chunk: int = FISTA_CHUNK) -> Tuple[torch.Tensor, torch.Tensor,
                                                 int]:
    """The inner FISTA from Y0 with step constant L0: chunks of ``chunk``
    machine steps, one host read of (done, k) after each.  Returns the last
    committed iterate, its L and the committed steps.

    On the GPU the first chunk runs eagerly (on a side stream: the graph's
    warm-up) and the rest replay it as a CUDA graph, captured once per
    inner solve: p, beta and the prox centre are fixed inside one, and so
    are the shapes.  The graph runs the same kernels in the same order as
    the eager chunk.  ``val`` and ``val_grad`` are those of
    :func:`al_functions` or :func:`prox_functions`."""
    _subproblem(val_grad)
    st = fista_init(Y0, L0, val_grad)

    def run_chunk(st):
        for _ in range(chunk):
            st = _machine_step(st, ops, params, val, val_grad)
        return st

    stream = graph = None
    if Y0.is_cuda:
        stream = torch.cuda.Stream(Y0.device)
        stream.wait_stream(torch.cuda.current_stream(Y0.device))
    while True:
        if graph is not None:
            graph.replay()
            counters.replays += 1
            for name, n in per_replay.items():
                counters.graph_runs[name] = (
                    counters.graph_runs.get(name, 0) + n)
        elif stream is not None:
            with torch.cuda.stream(stream):
                st = run_chunk(st)
            torch.cuda.current_stream(Y0.device).wait_stream(stream)
        else:
            st = run_chunk(st)
        done, k = counters.get(torch.stack([st.done.to(torch.int64), st.k]))
        if done or k >= params.maxiter_fista:
            return st.Y, st.L, int(k)
        if stream is not None and graph is None:
            graph, st, per_replay = _capture_chunk(st, run_chunk, stream)


def al_functions(ops: _Ops, p: torch.Tensor, beta: float):
    """The AL value and (value, gradient) of the subproblem (reference
    ``al_val_grad`` :208-214)."""
    sub = Subproblem(ops, p, beta)
    return sub.value, sub.value_grad


def prox_functions(ops: _Ops, p: torch.Tensor, beta: float, W: torch.Tensor,
                   lam: float):
    """The prox subproblem ``lam * AL(Y) + 1/2 ||Y - W||^2``: its value and
    (value, gradient) (reference ``prox_val_grad`` :277-284)."""
    sub = Subproblem(ops, p, beta, W, lam)
    return sub.value, sub.value_grad


def fista(ops: _Ops, params: HallarParams, Y0, p, beta: float, L0,
          counters: _Counters):
    """ADAP-FISTA on the AL subproblem (reference ``_make_fista``)."""
    val, val_grad = al_functions(ops, p, beta)
    return run_fista(ops, params, Y0, L0, val, val_grad, counters)


def aipp(ops: _Ops, params: HallarParams, Y0, p, beta: float, L0,
         counters: _Counters):
    """ADAP-AIPP on the AL subproblem (reference ``_make_aipp`` :323-350):
    at most ``aipp_max_prox`` prox rounds on the host, each a run of the
    inner machine on the prox subproblem; a round whose step fails the
    descent check halves lambda and retries."""
    al_val, _ = al_functions(ops, p, beta)
    W, lam, L, total_k = Y0, params.aipp_lambda0, L0, 0
    for _ in range(params.aipp_max_prox):
        val, val_grad = prox_functions(ops, p, beta, W, lam)
        Wn, L, k = run_fista(ops, params, W, L, val, val_grad, counters)
        ok = (lam * al_val(Wn) + 0.5 * _vdot(Wn - W, Wn - W)
              <= lam * al_val(W) + 1e-10)
        W_out = torch.where(ok, Wn, W)
        resid = torch.linalg.vector_norm(W_out - W) / lam
        done = ok & (resid <= params.aipp_rho
                     * (1.0 + torch.linalg.vector_norm(W_out)))
        ok_h, done_h = counters.get(torch.stack([ok, done]))
        W, total_k = W_out, total_k + k
        if not ok_h:
            lam = lam * 0.5
        if done_h:
            break
    return W, L, total_k


def default_lanczos_start(key: int, n: int) -> np.ndarray:
    """The Lanczos start vector for ``key``: a seeded standard normal draw
    on the host, so every device starts from the same vector."""
    return np.random.default_rng(key).standard_normal(n)


def hallar_solve(prob: SpectraplexProblem,
                 params: Optional[HallarParams] = None,
                 Y0: Optional[np.ndarray] = None,
                 verbose: bool = False,
                 device=None,
                 lanczos_start: Callable[[int, int], np.ndarray]
                 = default_lanczos_start) -> HallarResult:
    """Solve on ``device`` (default ``cuda:0``; the CPU only when asked).

    ``lanczos_start(key, n)`` gives the start vector of each Lanczos run:
    keys ``it`` (the escape direction) and ``10_000 + it`` (the dual
    certificate) in outer iteration ``it``, as the reference keys its
    ``jax.random`` draws."""
    params = params or HallarParams()
    dev = resolve_device(device)
    dtype = _DTYPES[params.dtype]
    np_dtype = np.dtype(params.dtype)
    ops = _Ops(prob, dtype, dev)
    counters = _Counters()
    t0 = time.time()

    max_rank = params.max_rank or int(np.sqrt(2.0 * prob.m) + 1)
    max_rank = min(max_rank, prob.n)

    if Y0 is None:
        rng = np.random.default_rng(0)
        r = min(params.init_rank, max_rank)
        Y0 = rng.normal(size=(prob.n, r))
        Y0 *= np.sqrt(prob.tau) / max(np.linalg.norm(Y0), 1e-12)
    Y = torch.tensor(np.asarray(Y0), dtype=dtype, device=dev)
    p_host = np.zeros(prob.m, np_dtype)
    p = torch.zeros(prob.m, dtype=dtype, device=dev)
    beta = params.beta0
    L = torch.tensor(params.L0_fista, dtype=dtype, device=dev)
    inner = aipp if params.inner_solver == "aipp" else fista

    def lanczos(w_host, key):
        w = torch.tensor(w_host, dtype=dtype, device=dev)
        v0 = torch.tensor(np.asarray(lanczos_start(key, prob.n)),
                          dtype=dtype, device=dev)
        counters.reads += 1
        return lanczos_min_eig_vec(lambda v: ops.SY(w, v[:, None])[:, 0],
                                   prob.n, v0, params.lanczos_iters)

    converged = False
    pinf = np.inf
    rel_gap = np.inf
    pobj = np.inf
    dval = -np.inf
    theta = 0.0
    steps = 0
    it = 0
    for it in range(params.maxiter_hallar):
        Y, L, k_inner = inner(ops, params, Y, p, beta, L, counters)
        steps += k_inner
        post = counters.get(torch.cat([ops.axc(Y),
                                       torch.linalg.vector_norm(Y)[None]
                                       ** 2]))
        ax, cx, ysq = post[:prob.m], post[prob.m], post[prob.m + 1]
        resid = ax - prob.b
        pinf_abs = float(np.linalg.norm(resid))
        pinf = pinf_abs / (1.0 + float(np.linalg.norm(prob.b)))
        pobj = float(cx)

        # escape direction: min eigvec of S = C + A*(p + beta resid)
        lam_esc, vmin = lanczos(p_host + beta * resid.astype(np_dtype), it)
        # dual certificate with the plain multiplier p
        lam_p, _ = lanczos(p_host, 10_000 + it)
        theta = max(-lam_p, 0.0)
        dval = -float(np.dot(prob.b, p_host)) - prob.tau * theta
        rel_gap = abs(pobj - dval) / (1.0 + abs(pobj) + abs(dval))

        if verbose:
            print(f"hallar it {it}: pobj {pobj:.6e} dval {dval:.6e} "
                  f"pinf {pinf:.2e} gap {rel_gap:.2e} rank {Y.shape[1]} "
                  f"beta {beta:.1f} fista {k_inner} lam_esc {lam_esc:.2e}",
                  flush=True)

        if pinf <= params.eps_pfeas and rel_gap <= params.eps_gap:
            converged = True
            break
        if time.time() - t0 > params.time_limit:
            break

        # rank escalation via escape direction (the reference forms the new
        # factor in numpy: Y scaled in float64 when the scale is not 1,
        # the new column in float64, the whole rounded to the compute type)
        slack = prob.tau - float(ysq)
        if (lam_esc < -params.escape_tol * (1.0 + abs(pobj))
                and Y.shape[1] < max_rank):
            step = np.sqrt(max(slack, 0.05 * prob.tau))
            col = torch.tensor(step * np.sqrt(0.05) * vmin[:, None],
                               device=dev)
            scaled = Y if slack > 0 else Y.double() * np.sqrt(0.95)
            Y = ops.project(torch.cat([scaled.double(), col], dim=1)
                            .to(dtype))

        # multiplier + penalty updates
        p_host = (p_host + beta * resid).astype(np_dtype)
        p = torch.tensor(p_host, device=dev)
        beta = min(max(beta * params.beta_inc, params.beta_min),
                   params.beta_max)

    Y_host = counters.get(Y)
    return HallarResult(
        Y=Y_host, p=p_host, theta=theta, pobj=pobj, dval=dval,
        pinf=pinf, rel_gap=rel_gap, iters=it + 1,
        final_rank=int(Y.shape[1]), solve_time=time.time() - t0,
        converged=converged, fista_steps=steps, host_reads=counters.reads,
        graph_replays=counters.replays, graph_runs=counters.graph_runs,
    )


def build_mss_problem(edges: List[Tuple[int, int]], n: int
                      ) -> SpectraplexProblem:
    """Maximum stable set SDP (HALLaR prototype's example family,
    ``hallar/py/MSS_SDP.py``):  max <ee^T, X>  s.t. X_ij = 0 for edges,
    tr X = 1  ->  min <-ee^T, X>, A(X) = 0, tau = 1."""
    E = len(edges)
    a_rows = np.array([min(e) for e in edges], np.int32)
    a_cols = np.array([max(e) for e in edges], np.int32)
    iu = np.triu_indices(n)
    return SpectraplexProblem(
        n=n, m=E, b=np.zeros(E), tau=1.0,
        c_rows=iu[0].astype(np.int32), c_cols=iu[1].astype(np.int32),
        c_vals=-np.ones(iu[0].size),
        a_rows=a_rows, a_cols=a_cols, a_vals=np.ones(E),
        a_cid=np.arange(E, dtype=np.int32),
    )
