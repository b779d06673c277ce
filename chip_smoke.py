#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits nonzero:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; no CUDA device -> exit 2 before anything else;
2. build the eight CUDA kernels from ``ltr_lowrank_sdp_torch/csrc`` (nvcc,
   sm_90a, all sources at once);
3. hold each kernel against its plain PyTorch version on the card, in
   float64, at the main paths' shapes: max relative error <= 1e-12, with the
   kernel's time, the plain version's time, the memory bound (bytes / 3.35
   TB/s) and, for the two SpMMs and the two LP segment sums, a yardstick
   built on one ``torch.sparse.mm`` call that computes the same function
   and that the port never calls.  K1-K4 on the n = 2^14 Delaunay MaxCut C at
   rank 20 and 64; on the n = 10^4 matrix-completion cone at rank 19 and 64,
   K1 (C = I scaled by the objective coefficient, no diagonal term, also at
   r = 1 and chained into K6 as ``apply_w`` does), K4 (U, V and ``U is V``
   on the 10^4 diagonal entries), K5 (single, ``U is V``, pair) and K6
   (alone, with an addend, r = 1, weights with zeros); K5 and K6 once more
   on a random sparse cone with several entries per constraint and a
   trace-like constraint of n entries; K5, K6 and the dense-objective
   ``apply_w`` chain (``torch.matmul`` then K6 accumulating onto it) on the
   Lovasz theta cone ``theta_sdpa(600, 60, seed=12)`` (the shape of
   Mittelmann theta12) at rank 13, 64, 102 and 1, and on the cone that phase 7
   solves, ``theta_sdpa(THETA_N, THETA_N // 4, seed=THETA_N)``, at the rank
   that solve runs at (its rank cap, 141, where a cone with m >= 20 n and
   n <= 400 starts) and 1 (the theta path's row of the ``kernels`` line); K5 on those cones' trace segments and on the
   4096-entry one, with and without the long-segment split, in all three
   modes; K5, K6 and the ``apply_w`` chain on each of the three blocks of
   the multi-block + LP main path (n = 1000, 800, 600) at the block's
   starting rank, which is the rank that solve ends at, and at 1, with the
   dense C @ Y product timed beside them; K7 and K8 at that path's LP
   shapes (60,000 entries, 20,000 columns, m = 2,400) and at ten times
   that.  A final rank of phase 6 or 7 that phase 3 did not cover is held
   right after its solve;
4. the MaxCut main path: ``ltr_lowrank_sdp_torch.cli.main`` on the Delaunay
   graph (n = 2^14, seed 14; the kind of SuiteSparse ``delaunay_n14``, solved
   with the LoRADS MaxCut row's flags ``--phase1Tol 1e+1 --heuristicFactor
   100``), with every launch counter set to 0 just before and read just
   after: status primal_dual_optimal, DIMACS errors <= 1e-5 (primal
   infeasibility and gap recomputed in float64 on the host), the trajectory
   JSON, K1-K4 launched and no plain version run; then a warm solve and one
   under the profiler;
5. the sparse-cone main path: matrix completion of a 5000 x 5000 rank-3
   matrix (``matcomp_problem(5000, 5000, 3, 2.0, seed=0)``: n = 10^4, the
   dimension of the LoRADS MC_10000 row, about 552,000 one-entry
   constraints) written as ``.dat-s`` and solved through the CLI with
   ``--heuristicFactor 10``, counters as above: K1, K4, K5, K6 launched, no
   plain version run, status primal_dual_optimal or primal_optimal, primal
   infeasibility <= 1e-5, gap and dual infeasibility <= 5e-5; then a warm
   solve and a window of one under the profiler;
6. the multi-block + LP main path: ``multiblock_lp_sdpa(dims=(1000, 800,
   600), m=2400, n_lp=20000, seed=0)`` (three coupled dense-objective blocks
   and an LP cone) written as ``.dat-s`` with the LP block last and solved
   through the CLI with default flags, counters as above: K5, K6, K7, K8
   launched, nothing else and no plain version run, one final rank per
   block, the same limits as phase 5 (the LP columns enter the host
   recomputation); then a warm solve and a profiler window;
7. the Lovasz theta path: ``theta_sdpa(THETA_N, THETA_N // 4, seed=THETA_N)``
   through the CLI (dense objective, rank 141 from the start): K5 and K6
   launched, nothing else, the same limits, inside ``THETA_LIMIT_S`` (no
   warm solve and no profiler window: the solve is a long one);
8. GPU against CPU on a G11-sized random MaxCut (n = 800), a small matrix
   completion (n = 400), ``random_multiblock_problem()`` with the
   Gauss-Seidel and the Jacobi sweep, the 1/10-scale multi-block + LP
   instance and ``theta_sdpa(80, 20, 80)``: same status and ranks, pobj
   equal to 1e-6 relative.  Two solves that parted in a reopt round (other
   iteration counts) and ended further apart are instead solved again with
   ``reopt_level=0`` and held there, at the end of the main ALM and ADMM
   phases: same counts, pobj equal to 1e-6 relative; that the full solves
   lie within their own certified gaps, ``|p - p'| <= (gap + gap') (1 +
   |pobj| + |dobj|) + 1e-6 |pobj|``, is printed as a second check;
9. the ``kernels`` JSON line (each kernel's row, and under ``by_path`` its
   row at every main path's shapes), the kernels still to be ported, the
   solver loops carried as plain torch over the kernels, the card line
   and, last, ``{"ok": true, "device": {...}}``.

Two measurements outside the smoke run, for a Lovasz theta instance too long
for it.  The first builds the kernels, solves the one instance through the
CLI on the card and prints its status, ranks, counts and times, nothing
else; with ``--profile`` it instead runs the solve under ``torch.profiler``
until the solver's first time-limit check after S seconds (one per ALM outer
iteration) and prints the device's busy share of that window (the profiler
needs minutes to digest some 10^5 device kernels):

    python3 chip_smoke.py --theta-solve N,AVG_DEGREE,SEED --time-limit S [--logfile PATH]
    python3 chip_smoke.py --theta-solve N,AVG_DEGREE,SEED --time-limit S --profile
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import torch

# H100 SXM: HBM3 rate and FP64 (non-tensor-core) peak, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
KERNEL_RTOL = 1e-12
MAIN_N = 2 ** 14
MAIN_SEED = 14
CHECK_RANKS = (20, 64)
REPORT_RANK = 20          # ceil(2 ln 2^14): the main path's starting rank
MAIN_FLAGS = ("--phase1Tol", "1e+1", "--heuristicFactor", "100")
# the sparse-cone main path: nuclear-norm completion of an (MC_N1, MC_N1)
# rank-3 matrix, the generator's default sampling, the flags of the JAX
# package's matrix-completion test
MC_N1 = 5000
MC_ARGS = (MC_N1, MC_N1, 3, 2.0, 0)
MC_FLAGS = ("--heuristicFactor", "10")
MC_CHECK_RANKS = (19, 64)
MC_REPORT_RANK = 19       # ceil(2 ln 10^4): that path's starting rank
MC_SMALL_ARGS = (200, 200, 2, 1.0, 0)
PROFILE_WINDOW_S = 2.0    # a longer solve is profiled for about this long
MAXCUT_KERNELS = ("spmm_sym_csr", "diag_rowdot", "diag_normal_matvec",
                  "sym_contract_sum")
SPARSE_KERNELS = ("spmm_sym_csr", "sym_contract_sum", "coo_contract_segsum",
                  "spmm_constr_csr")
# the multi-block + LP main path: three dense-objective blocks coupled
# through every constraint, and an LP cone; default flags
MB_DIMS = (1000, 800, 600)
MB_M = 2400
MB_NLP = 20000
MB_SEED = 0
MB_REPORT_RANK = 14       # ceil(2 ln 1000): the largest block's starting rank
MB_KERNELS = ("coo_contract_segsum", "spmm_constr_csr", "lp_constr_segsum",
              "lp_col_wsum")
MB_SMALL = dict(dims=(100, 80, 60), m=240, n_lp=2000, seed=0)
# the Lovasz theta shapes: the operators at the width of Mittelmann theta12,
# and the solve of the theta main path (the rank grows on the card in phase
# 8's theta80 solve, 9 to 21, and in a --theta-solve of the theta12 shape)
THETA12_ARGS = (600, 60, 12)
# ceil(2 ln 600), a grown rank, the rank a solve of this shape ends at, Lanczos
THETA12_RANKS = (13, 64, 102, 1)
THETA_N = 300
# m >= 20 n and n <= 400: the solve starts, and stays, at the rank cap
THETA_RANKS = (141, 1)           # the solve's rank, Lanczos
THETA_LIMIT_S = 180.0
DENSE_KERNELS = ("coo_contract_segsum", "spmm_constr_csr")
SLEEP_CYCLES = 50_000_000  # about 30 ms at the H100's clocks

UNPORTED = [
    "P  scripts/pallas_gather_probe.py:40-65 kern (pallas_call :57): "
    "gather-sum probe; later an H100 gather micro-benchmark",
    "14 ltr_lowrank_sdp_tpu/models/gatv2.py:26,94 segment_softmax, "
    "segment_sum; layers.py:93-99; net.py:90-93 (ML slice)",
    "15 ltr_lowrank_sdp_tpu/hallar/solver.py:179,188 _Ops.AX, _Ops.SY "
    "(HALLaR slice)",
    "16 ltr_lowrank_sdp_tpu/parallel/meshops.py:211,220 _local_reduce, "
    "_local_spmm (parallel slice)",
]
# The reference's device-resident solver loops are jnp loops over the
# operators above, with no gather or segment-reduction kernel of their own;
# the port carries them as plain torch loops over K1-K8.  A fused or
# CUDA-graph version is performance work, not a kernel still to be ported.
LOOPS = [
    "11 ltr_lowrank_sdp_tpu/ops/cg.py:31 cg_solve, ops/lanczos.py:23 "
    "lanczos_tridiag -> ltr_lowrank_sdp_torch/ops/cg.py, ops/lanczos.py",
    "12 ltr_lowrank_sdp_tpu/ops/lbfgs.py:71,48 direction, push_pair -> "
    "ltr_lowrank_sdp_torch/ops/lbfgs.py",
    "13 ltr_lowrank_sdp_tpu/ops/lanczos.py:162 oracle_rank_gram -> "
    "ltr_lowrank_sdp_torch/ops/lanczos.py (torch.matmul + host eigh)",
]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up.

    At these sizes one launch runs for a few microseconds, less than the
    host needs to issue it, so back-to-back launches would time the host.
    A sleep kernel queued first holds the stream while the host issues all
    ``iters`` calls; the events then bracket device work only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_call_ms(fn, iters: int = 50) -> float:
    """Mean wall time of one call issued back to back, synchronized at the
    end: what a caller that launches the kernel in a loop sees."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP64_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def profile_solve(solver, tag: str = "profile") -> None:
    """One solve under ``torch.profiler``: device busy share of the wall
    time and the kernels that take it.  (A solver whose params carry a time
    limit stops there: the window of a long solve.)"""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        solver.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        c, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / 1e6
    print(f"[{tag}] solve wall {wall:.3f} s under the profiler, device "
          f"busy {busy:.4f} s ({100 * busy / wall:.1f} %), "
          f"{len(kernels)} device kernels")
    for name, (c, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:12]:
        print(f"[{tag}] {us / 1e3:9.3f} ms {c:6d} x {name[:90]}", flush=True)


def _measure(name, tag, kern, plain, nbytes, flops, lib=None, extra=()):
    """Hold one kernel call against its plain version (and the ``extra``
    (kernel, plain) pairs: other operand modes, correctness only), then time
    both and the library yardstick.  Returns the kernels-line fields."""
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    rel = max(rel_err(a, b) for a, b in zip(out_k, out_p))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    for kx, px in extra:
        a, b = kx(), px()
        torch.cuda.synchronize()
        rel = max(rel, rel_err(a, b))
    require(rel <= KERNEL_RTOL,
            f"{name} {tag}: rel err {rel:.3e} > {KERNEL_RTOL}")
    ms, plain_ms, call_ms = time_ms(kern), time_ms(plain), host_call_ms(kern)
    lib_ms = None
    if lib is not None:
        out_l = lib()
        out_l = out_l if isinstance(out_l, tuple) else (out_l,)
        require(max(rel_err(a, b) for a, b in zip(out_k, out_l))
                <= KERNEL_RTOL, f"{name} {tag}: library result differs")
        lib_ms = time_ms(lib)
    b_ms, b_by = bound_ms(nbytes, flops)
    lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "null"
    print(f"[kernel] {name} {tag}: max rel err {rel:.2e} (tol "
          f"{KERNEL_RTOL:g}), max abs err {abs_err:.2e}, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
          f"{lib_txt} ms, {nbytes / ms / 1e6:.1f} GB/s; host-issued call "
          f"{call_ms:.4f} ms", flush=True)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_kernels(K, cone, dev):
    """Phase 3.  Returns {name: row} for the kernels line at REPORT_RANK."""
    n = cone.n
    csr = cone.c_csr
    nnz_full, nnz_up = csr.nnz, cone.c_nnz
    dv = cone.diag_val
    rows, cols, coef = cone.c_rows, cone.c_cols, cone.c_double_coef
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        c_sparse = torch.sparse_csr_tensor(
            csr.indptr, csr.indices, csr.vals, size=(n, n),
            check_invariants=True)
    g = torch.Generator(device=dev).manual_seed(2024)
    report = {}
    for r in CHECK_RANKS:
        def rnd(*shape):
            return torch.randn(shape, generator=g, dtype=torch.float64,
                               device=dev)

        Y, U, V = rnd(n, r), rnd(n, r), rnd(n, r)
        w = rnd(n)
        f8, i4 = 8, 4
        cases = {
            # name: (kernel call, plain call, bytes, flops, library call)
            "spmm_sym_csr": (
                lambda: K.spmm_sym_csr(csr, Y, 1.0),
                lambda: K.spmm_sym_csr_plain(csr, Y, 1.0),
                (n + 1) * i4 + nnz_full * (i4 + f8) + 2 * n * r * f8,
                2.0 * nnz_full * r + n * r,
                lambda: torch.sparse.mm(c_sparse, Y)),
            "diag_rowdot": (
                lambda: K.diag_rowdot(U, V, dv, 2.0, second=True),
                lambda: K.diag_rowdot_plain(U, V, dv, 2.0, second=True),
                2 * n * r * f8 + n * f8 + 2 * n * f8,
                4.0 * n * r + 3 * n, None),
            "diag_normal_matvec": (
                lambda: K.diag_normal_matvec(U, V, dv),
                lambda: K.diag_normal_matvec_plain(U, V, dv),
                3 * n * r * f8 + n * f8, 4.0 * n * r + 2 * n, None),
            "sym_contract_sum": (
                lambda: K.sym_contract_sum(rows, cols, coef, U, U),
                lambda: K.sym_contract_sum_plain(rows, cols, coef, U, U),
                nnz_up * (2 * i4 + f8) + n * r * f8 + f8,
                (2.0 * r + 1) * nnz_up, None),
        }
        # the other operand modes each kernel has on the path: correctness
        extra = {
            "spmm_sym_csr": [
                (lambda: K.spmm_sym_csr(csr, Y, 0.5, w),
                 lambda: K.spmm_sym_csr_plain(csr, Y, 0.5, w)),
                (lambda: K.spmm_sym_csr(None, Y, 0.0, w),
                 lambda: K.spmm_sym_csr_plain(None, Y, 0.0, w)),
                (lambda: K.spmm_sym_csr(csr, Y[:, :1].contiguous(), 2.0, w),
                 lambda: K.spmm_sym_csr_plain(csr, Y[:, :1].contiguous(),
                                              2.0, w))],
            "diag_rowdot": [(lambda: K.diag_rowdot(U, V, dv, 1.0),
                             lambda: K.diag_rowdot_plain(U, V, dv, 1.0))],
            "diag_normal_matvec": [],
            "sym_contract_sum": [
                (lambda: K.sym_contract_sum(rows, cols, coef, U, V),
                 lambda: K.sym_contract_sum_plain(rows, cols, coef, U, V))],
        }
        for name, (kern, plain, nbytes, flops, lib) in cases.items():
            row = _measure(name, f"n={n} r={r}", kern, plain, nbytes, flops,
                           lib, extra[name])
            if r == REPORT_RANK:
                report[name] = row
    return report


def check_objective_kernels(K, cone, dev, ranks, report_rank, tag,
                            alpha=0.37):
    """Phase 3 for K1 and K4 as a general cone's path calls them: K1 as
    ``alpha * C @ Y`` with no diagonal term (``apply_w``'s first launch, its
    output then K6's addend; r = 1 from the Lanczos certificate) and K4 on
    the cone's own C entries.  Returns {name: row} at ``report_rank``."""
    n, csr = cone.n, cone.c_csr
    nnz_full, nnz_up = csr.nnz, cone.c_nnz
    rows, cols, coef = cone.c_rows, cone.c_cols, cone.c_double_coef
    f8, i4 = 8, 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        c_scaled = torch.sparse_csr_tensor(
            csr.indptr, csr.indices, alpha * csr.vals, size=(n, n),
            check_invariants=True)
    g = torch.Generator(device=dev).manual_seed(2026)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    report = {}
    w = rnd(cone.m)
    for r in (*ranks, 1):
        Y, U, V = rnd(n, r), rnd(n, r), rnd(n, r)
        shape = f"{tag} n={n} C nnz={nnz_up} r={r}"
        k1 = _measure(
            "spmm_sym_csr", f"alpha={alpha} no-d {shape}",
            lambda: K.spmm_sym_csr(csr, Y, alpha),
            lambda: K.spmm_sym_csr_plain(csr, Y, alpha),
            (n + 1) * i4 + nnz_full * (i4 + f8) + 2 * n * r * f8,
            2.0 * nnz_full * r + n * r,
            lambda: torch.sparse.mm(c_scaled, Y))
        # apply_w on this path: K1, then K6 accumulating onto K1's output
        got = K.spmm_constr_csr(cone.a_csr, w, Y,
                                Z=K.spmm_sym_csr(csr, Y, alpha))
        want = K.spmm_constr_csr_plain(
            cone.a_csr, w, Y, Z=K.spmm_sym_csr_plain(csr, Y, alpha))
        require(rel_err(got, want) <= KERNEL_RTOL,
                f"K1 then K6 {shape}: apply_w differs")
        if r == 1:
            continue        # K4 runs at the factors' rank only
        k4 = _measure(
            "sym_contract_sum", f"U-is-V {shape}",
            lambda: K.sym_contract_sum(rows, cols, coef, U, U),
            lambda: K.sym_contract_sum_plain(rows, cols, coef, U, U),
            nnz_up * (2 * i4 + f8) + n * r * f8 + f8,
            (2.0 * r + 1) * nnz_up, None,
            [(lambda: K.sym_contract_sum(rows, cols, coef, U, V),
              lambda: K.sym_contract_sum_plain(rows, cols, coef, U, V))])
        if r == report_rank:
            report = {"spmm_sym_csr": k1, "sym_contract_sum": k4}
    return report


def check_general_kernels(K, seg, csr, dev, ranks, report_rank, tag):
    """Phase 3 for K5 and K6 on one cone's two layouts.  Returns {name: row}
    at ``report_rank``: K5 in pair mode (the ALM line search, once per inner
    iteration) and K6 alone (the ALM gradient's A*(w) R)."""
    n, m, nnz, slots = seg.n, seg.m, seg.nnz, csr.nnz
    f8, i4 = 8, 4
    g = torch.Generator(device=dev).manual_seed(2025)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    report = {}
    for r in ranks:
        U, V, Z = rnd(n, r), rnd(n, r), rnd(n, r)
        w = rnd(m)
        w0 = torch.where(torch.arange(m, device=dev) % 3 == 0, 0.0, w)
        u1 = U[:, :1].contiguous()
        # the yardstick: one CSR product with the slot weights w[cid] * val
        # multiplied in beforehand (and equal (row, col) slots merged), so
        # it leaves out the weight gather that K6 does on every call
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s_w = torch.sparse_coo_tensor(
                torch.stack([csr.row_ids, csr.indices.long()]),
                w[csr.cid.long()] * csr.vals,
                size=(n, n)).coalesce().to_sparse_csr()
        k5_bytes = (m + 1) * i4 + nnz * (2 * i4 + f8) + m * f8
        k6_bytes = ((n + 1) * i4 + slots * (2 * i4 + f8) + m * f8
                    + 2 * n * r * f8)
        shape = f"{tag} n={n} m={m} nnz={nnz} r={r}"
        rows = {
            "coo_contract_segsum": _measure(
                "coo_contract_segsum", f"pair {shape}",
                lambda: K.coo_contract_segsum(seg, U, V, pair=True),
                lambda: K.coo_contract_segsum_plain(seg, U, V, pair=True),
                k5_bytes + 2 * n * r * f8 + m * f8, 6.0 * nnz * r),
            "spmm_constr_csr": _measure(
                "spmm_constr_csr", f"alone {shape} slots={slots}",
                lambda: K.spmm_constr_csr(csr, w, U),
                lambda: K.spmm_constr_csr_plain(csr, w, U),
                k6_bytes, 2.0 * slots * r + slots,
                lambda: torch.sparse.mm(s_w, U)),
        }
        _measure("coo_contract_segsum", f"single {shape}",
                 lambda: K.coo_contract_segsum(seg, U, V),
                 lambda: K.coo_contract_segsum_plain(seg, U, V),
                 k5_bytes + 2 * n * r * f8, 4.0 * nnz * r)
        _measure("coo_contract_segsum", f"U-is-V {shape}",
                 lambda: K.coo_contract_segsum(seg, U, U),
                 lambda: K.coo_contract_segsum_plain(seg, U, U),
                 k5_bytes + n * r * f8, 2.0 * nnz * r)
        _measure("spmm_constr_csr", f"addend {shape}",
                 lambda: K.spmm_constr_csr(csr, w, U, Z=Z, beta=1.0),
                 lambda: K.spmm_constr_csr_plain(csr, w, U, Z=Z, beta=1.0),
                 k6_bytes + n * r * f8, 2.0 * slots * r + slots + n * r)
        _measure("spmm_constr_csr", f"zero-weights {shape}",
                 lambda: K.spmm_constr_csr(csr, w0, U, Z=Z, beta=-0.5),
                 lambda: K.spmm_constr_csr_plain(csr, w0, U, Z=Z, beta=-0.5),
                 k6_bytes + n * r * f8, 2.0 * slots * r + slots + n * r)
        _measure("spmm_constr_csr", f"r=1 {tag} n={n} m={m} slots={slots}",
                 lambda: K.spmm_constr_csr(csr, w, u1, Z=u1),
                 lambda: K.spmm_constr_csr_plain(csr, w, u1, Z=u1),
                 (n + 1) * i4 + slots * (2 * i4 + f8) + m * f8 + 3 * n * f8,
                 3.0 * slots + n)
        # the ADMM normal-equation matvec: K5 then K6, nothing between
        got = K.spmm_constr_csr(csr, K.coo_contract_segsum(seg, U, V), V, Z=U)
        want = K.spmm_constr_csr_plain(
            csr, K.coo_contract_segsum_plain(seg, U, V), V, Z=U)
        require(rel_err(got, want) <= KERNEL_RTOL,
                f"K5 then K6 {shape}: normal-equation matvec differs")
        # no atomics: the same bits on every call
        require(torch.equal(K.coo_contract_segsum(seg, U, V),
                            K.coo_contract_segsum(seg, U, V))
                and torch.equal(K.spmm_constr_csr(csr, w, U),
                                K.spmm_constr_csr(csr, w, U)),
                f"K5/K6 {shape}: two calls gave different bits")
        if r == report_rank:
            report = rows
    return report


def trace_cone_entries(n=4096, m=8192, nnz_per=4, seed=3):
    """``(rows, cols, vals, cid, n, m + 1)`` of a random sparse cone with
    ``nnz_per`` entries per constraint (repeats and diagonal entries
    included), one constraint with no entry, and a last, trace-like
    constraint of n diagonal entries."""
    import numpy as np

    from ltr_lowrank_sdp_torch.testing import random_sparse_cone

    cone = random_sparse_cone(np.random.default_rng(seed), n, m,
                              nnz_per=nnz_per, force_kind="sparse").cones[0]
    keep = cone.a_cid != 1
    diag = np.arange(n)
    rows = np.concatenate([cone.a_rows[keep], diag])
    cols = np.concatenate([cone.a_cols[keep], diag])
    vals = np.concatenate([cone.a_vals[keep], np.ones(n)])
    cid = np.concatenate([cone.a_cid[keep], np.full(n, m)])
    return rows, cols, vals, cid, n, m + 1


def check_long_segments(K, entries, dev, r, tag):
    """K5 on a cone with one long segment, with the long-segment split (the
    layout the port builds) and without it (every segment one warp's walk),
    all three modes, both timed in this call: same values to KERNEL_RTOL, the
    same bits on repeated calls."""
    rows, cols, vals, cid, n, m = entries
    split = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev)
    whole = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev,
                              long_thresh=None)
    require(split.n_chunks > 0 and whole.n_chunks == 0,
            f"{tag}: the layout has a long segment")
    longest = int((split.seg_ptr[1:] - split.seg_ptr[:-1]).max())
    g = torch.Generator(device=dev).manual_seed(2027)
    U = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
    V = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
    for mode, a, b, pair in (("single", U, V, False), ("U-is-V", U, U, False),
                             ("pair", U, V, True)):
        got = K.coo_contract_segsum(split, a, b, pair=pair)
        ref = K.coo_contract_segsum(whole, a, b, pair=pair)
        plain = K.coo_contract_segsum_plain(split, a, b, pair=pair)
        again = K.coo_contract_segsum(split, a, b, pair=pair)
        torch.cuda.synchronize()
        if not pair:
            got, ref, plain, again = (got,), (ref,), (plain,), (again,)
        rel = max(max(rel_err(x, y), rel_err(x, z))
                  for x, y, z in zip(got, ref, plain))
        require(rel <= KERNEL_RTOL, f"K5 {tag} {mode}: split differs {rel:.2e}")
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"K5 {tag} {mode}: two calls gave different bits")
        ms_split = time_ms(
            lambda: K.coo_contract_segsum(split, a, b, pair=pair))
        ms_whole = time_ms(
            lambda: K.coo_contract_segsum(whole, a, b, pair=pair))
        print(f"[kernel] coo_contract_segsum long-segment {tag} n={n} m={m} "
              f"longest={longest} chunks={split.n_chunks} r={r} {mode}: with "
              f"the split {ms_split:.4f} ms, without {ms_whole:.4f} ms, max "
              f"rel err {rel:.2e}, same bits on two calls", flush=True)


def check_dense_objective(K, cone, dev, ranks, tag):
    """The dense-objective ``apply_w`` chain of a cone: ``obj_coef * C @ Y``
    by ``torch.matmul`` (no kernel of the port, as in the JAX package), then
    K6 accumulating A*(w) Y onto it, against the plain chain; the product's
    time is recorded beside the kernels'."""
    n = cone.n
    C = cone.c_dense
    require(C is not None and cone.c_csr is None,
            f"{tag}: dense objective, no CSR of it")
    g = torch.Generator(device=dev).manual_seed(2028)
    w = torch.randn(cone.m, generator=g, dtype=torch.float64, device=dev)
    for r in ranks:
        Y = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
        got = cone.apply_w(w, Y, obj_coef=0.37)
        want = K.spmm_constr_csr_plain(cone.a_csr, w, Y,
                                       Z=0.37 * torch.matmul(C, Y))
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        require(rel <= KERNEL_RTOL, f"{tag} r={r}: dense apply_w differs")
        ms = time_ms(lambda: torch.matmul(C, Y))
        chain = time_ms(lambda: cone.apply_w(w, Y, obj_coef=0.37))
        b_ms, b_by = bound_ms((n * n + 2 * n * r) * 8, 2.0 * n * n * r)
        print(f"[gemm] {tag} C @ Y n={n} r={r} float64 torch.matmul: "
              f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); apply_w chain "
              f"(matmul, scale, K6 with addend) {chain:.4f} ms, max rel err "
              f"{rel:.2e}", flush=True)


def check_dense_cone(K, pcone, dev, ranks, report_rank, tag, relabel=False):
    """Phase 3 for one dense-objective cone of a main path, at that path's
    own shapes and the ranks named: K5 and K6 (``check_general_kernels``),
    the ``apply_w`` chain (``check_dense_objective``) and, where the cone has
    a long segment, K5 with and without the split.  ``relabel`` builds the
    operators as a single-cone solve does.  Returns {name: row} at
    ``report_rank``."""
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps

    cone = ConeOps(pcone, dev, constr_relabel=relabel)
    require((pcone.kind_a, pcone.kind_c) == ("dense", "dense"),
            f"{tag} is a dense cone")
    print(f"[problem] {tag}: n={pcone.n} m={pcone.m} A upper nnz "
          f"{cone.a_seg.nnz}, full CSR slots {cone.a_csr.nnz}, chunks "
          f"{cone.a_seg.n_chunks}, rank cap {pcone.rank_max}, ranks {ranks}",
          flush=True)
    rows = check_general_kernels(K, cone.a_seg, cone.a_csr, dev, ranks,
                                 report_rank, tag)
    check_dense_objective(K, cone, dev, ranks, tag)
    if cone.a_seg.n_chunks:
        for r in ranks:
            check_long_segments(K, (pcone.a_rows, pcone.a_cols, pcone.a_vals,
                                    pcone.a_cid, pcone.n, pcone.m), dev, r,
                                tag)
    return rows


def check_lp_kernels(K, lp, dev, tag):
    """Phase 3 for K7 and K8 on one LP cone's layouts.  Returns {name: row}:
    K7 in pair mode (the ALM line search, once per inner iteration) and K8
    (the ALM gradient's LP term).  Each yardstick computes the whole
    function that the kernel's row times, around one ``torch.sparse.mm`` on
    the entries as a sparse CSR matrix: for K7 the products u * v (pair: 2 u
    * v and v * v as two columns of one right side) and the product; for K8
    the product with w as one column plus the objective term c0 * c."""
    m, n_cols, nnz = lp.m, lp.n_cols, lp.nnz
    f8, i4 = 8, 4
    g = torch.Generator(device=dev).manual_seed(2029)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    u, v, w = rnd(n_cols), rnd(n_cols), rnd(m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        a_csr = torch.sparse_csr_tensor(lp.row_ptr, lp.row_col, lp.row_val,
                                        size=(m, n_cols))
        at_csr = torch.sparse_csr_tensor(lp.col_ptr, lp.col_cid, lp.col_val,
                                         size=(n_cols, m))
    w1 = w[:, None].contiguous()
    shape = f"{tag} m={m} cols={n_cols} nnz={nnz}"
    k7_bytes = (m + 1) * i4 + nnz * (i4 + f8) + 2 * n_cols * f8
    rows = {
        "lp_constr_segsum": _measure(
            "lp_constr_segsum", f"pair {shape}",
            lambda: K.lp_constr_segsum(lp, u, v, pair=True),
            lambda: K.lp_constr_segsum_plain(lp, u, v, pair=True),
            k7_bytes + 2 * m * f8, 5.0 * nnz,
            lambda: torch.sparse.mm(
                a_csr, torch.stack((2.0 * u * v, v * v), dim=1)).unbind(1)),
        "lp_col_wsum": _measure(
            "lp_col_wsum", shape,
            lambda: K.lp_col_wsum(lp, w, 0.37),
            lambda: K.lp_col_wsum_plain(lp, w, 0.37),
            (n_cols + 1) * i4 + nnz * (i4 + f8) + m * f8 + 2 * n_cols * f8,
            2.0 * nnz + 2 * n_cols,
            lambda: 0.37 * lp.c + torch.sparse.mm(at_csr, w1).reshape(-1),
            [(lambda: K.lp_col_wsum(lp, w, 0.0),
                    lambda: K.lp_col_wsum_plain(lp, w, 0.0))]),
    }
    _measure(
        "lp_constr_segsum", f"single {shape}",
        lambda: K.lp_constr_segsum(lp, u, v),
        lambda: K.lp_constr_segsum_plain(lp, u, v),
        k7_bytes + m * f8, 3.0 * nnz,
        lambda: torch.sparse.mm(a_csr, (u * v)[:, None]).reshape(-1),
        [(lambda: K.lp_constr_segsum(lp, v, v),
          lambda: K.lp_constr_segsum_plain(lp, v, v))])
    require(torch.equal(K.lp_constr_segsum(lp, u, v),
                        K.lp_constr_segsum(lp, u, v))
            and torch.equal(K.lp_col_wsum(lp, w, 0.37),
                            K.lp_col_wsum(lp, w, 0.37)),
            f"K7/K8 {shape}: two calls gave different bits")
    return rows


def run_main_path(tag, path, flags, launched, statuses, limits, dev,
                  n_blocks=1, repeat=True):
    """Drive one main path through the CLI with the launch counters set to 0
    just before and read just after, check the result by the repo's own
    means, then (with ``repeat``) solve again warm and once under the
    profiler.  Returns the counts of the CLI run and its result."""
    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.problem import load_problem
    from ltr_lowrank_sdp_torch.solver.common import host_metrics_f64
    from ltr_lowrank_sdp_torch.solver.driver import Solver

    jpath = os.path.join(os.path.dirname(path), f"{tag}_solution.json")
    K.reset_counts()
    t = time.perf_counter()
    res = cli.main([path, *flags, "--jsonfile", jpath])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.counts()
    print(f"[{tag}] counts {json.dumps(counts)}")
    print(f"[{tag}] cli wall {wall:.3f} s, solve {res.solve_time:.3f} s, "
          f"stages {json.dumps({k: round(v, 4) for k, v in res.stage_times.items()})}")
    print(f"[{tag}] status {res.status.value}, ALM outer "
          f"{res.alm_outer_iters} inner {res.alm_inner_iters}, ADMM "
          f"{res.admm_iters}, CG total {res.cg_iters}, host syncs "
          f"{res.host_syncs}, final ranks {res.final_ranks}", flush=True)
    for name, (launches, plain_calls) in counts.items():
        if name in launched:
            require(launches > 0, f"{name} was not launched on the {tag} path")
        else:
            require(launches == 0, f"{name} ran on the {tag} path")
        require(plain_calls == 0,
                f"{name}'s plain version ran on the {tag} path")
    require(res.status in statuses, f"{tag}: status {res.status.value}")
    require(len(res.final_ranks) == n_blocks,
            f"{tag}: one final rank per block")
    t = time.perf_counter()
    prob = load_problem(path)
    print(f"[{tag}] load_problem {time.perf_counter() - t:.3f} s")
    Ravg = tuple(0.5 * (u + v) for u, v in zip(res.U, res.V))
    lp_avg = None if res.ulp is None else 0.5 * (res.ulp + res.vlp)
    require((lp_avg is None) == (prob.lp is None),
            f"{tag}: LP factors returned with an LP cone")
    pobj, dobj, pinf, pinf_inf, gap = host_metrics_f64(
        prob, Ravg, Ravg, lp_avg, lp_avg, res.dual, res.obj_scale)
    print(f"[{tag}] host f64: pobj {pobj:.10e} dobj {dobj:.10e} "
          f"pinf_l1 {pinf:.3e} gap {gap:.3e}; solver dinf_l1 "
          f"{res.dinf_l1:.3e}")
    pinf_lim, gap_lim, dinf_lim = limits
    require(pinf <= pinf_lim and gap <= gap_lim and res.dinf_l1 <= dinf_lim,
            f"{tag}: DIMACS errors above {limits}")
    require(abs(pobj - res.pobj) <= 1e-8 * abs(pobj),
            f"{tag}: device pobj disagrees with the host recomputation")
    with open(jpath) as f:
        payload = json.load(f)
    require(set(payload) == {"problem_id", "file_path", "metrics",
                             "trajectory"}, f"{tag}: trajectory JSON keys")
    require(set(payload["trajectory"]) == {"phase_1", "phase_2"},
            f"{tag}: trajectory phases")
    if not repeat:
        return counts, res

    # the same solve again, warm, then once more under the profiler
    params = cli.params_from_args(cli.build_arg_parser().parse_args(
        [path, *flags]))
    solver = Solver(prob, params, device=dev)
    t = time.perf_counter()
    warm = solver.solve()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    print(f"[{tag}] warm solve {warm_s:.3f} s (status {warm.status.value}, "
          f"ALM inner {warm.alm_inner_iters}, ADMM {warm.admm_iters})")
    ptag = "profile" if tag == "main" else f"{tag}-profile"
    if warm_s > PROFILE_WINDOW_S:
        # a long solve: profile its first PROFILE_WINDOW_S seconds (the
        # solver leaves at its next time-limit check after that)
        print(f"[{ptag}] the window: a solve with a time limit of "
              f"{PROFILE_WINDOW_S} s")
        solver = Solver(prob, dataclasses.replace(
            params, time_sec_limit=PROFILE_WINDOW_S), device=dev)
    profile_solve(solver, ptag)
    return counts, res


def theta_solve(spec: str, limit_s: float, profile: bool, logfile) -> int:
    """``--theta-solve``: one theta instance through the CLI on the card,
    whatever its status; the solver's rows go to ``logfile`` if one is
    named.  With ``profile``, a window of the solve under the profiler
    instead."""
    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.config import SolverParams
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import (theta_problem, theta_sdpa,
                                               write_sdpa)

    n, deg, seed = (int(x) for x in spec.split(","))
    print(f"[card] {card_line()}")
    K.build_kernels()
    if profile:
        print(f"[theta-profile] theta_sdpa({n}, {deg}, {seed}), the window: "
              f"a solve with a time limit of {limit_s:g} s")
        profile_solve(Solver(theta_problem(n, deg, seed),
                             SolverParams(time_sec_limit=limit_s)),
                      "theta-profile")
        return 0
    log_flags = ("--logfile", logfile) if logfile else ()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"theta_{n}_{deg}_{seed}.dat-s")
        write_sdpa(path, theta_sdpa(n, deg, seed))
        K.reset_counts()
        t = time.perf_counter()
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            res = cli.main([path, "--timeSecLimit", str(limit_s),
                            *log_flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    print(f"[theta-solve] theta_sdpa({n}, {deg}, {seed}) time limit "
          f"{limit_s:g} s: status {res.status.value}, final ranks "
          f"{res.final_ranks}, ALM outer {res.alm_outer_iters} inner "
          f"{res.alm_inner_iters}, ADMM {res.admm_iters}, CG "
          f"{res.cg_iters}, host syncs {res.host_syncs}, pobj "
          f"{res.pobj:.10e} dobj {res.dobj:.10e} pinf_l1 {res.pinf_l1:.3e} "
          f"gap {res.gap:.3e} dinf_l1 {res.dinf_l1:.3e}, solve "
          f"{res.solve_time:.1f} s, cli wall {wall:.1f} s, stages "
          f"{json.dumps({k: round(v, 2) for k, v in res.stage_times.items()})}"
          f", counts {json.dumps(K.counts())}")
    return 0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        ap = argparse.ArgumentParser()
        ap.add_argument("--theta-solve", required=True,
                        metavar="N,AVG_DEGREE,SEED")
        ap.add_argument("--time-limit", type=float, default=600.0)
        ap.add_argument("--profile", action="store_true")
        ap.add_argument("--logfile", default=None)
        args = ap.parse_args()
        return theta_solve(args.theta_solve, args.time_limit, args.profile,
                           args.logfile)
    card = card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    import scipy.io

    from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps, LPOps
    from ltr_lowrank_sdp_torch.problem import canonicalize, initial_ranks
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                               matcomp_problem, matcomp_sdpa,
                                               multiblock_lp_problem,
                                               multiblock_lp_sdpa,
                                               random_maxcut_problem,
                                               random_multiblock_problem,
                                               theta_problem, theta_sdpa,
                                               write_sdpa)

    dev = torch.device("cuda", torch.cuda.current_device())

    # ---- phase 2: build ------------------------------------------------ #
    t = time.perf_counter()
    built = K.build_kernels()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t:.1f} s "
          f"({', '.join(built)})")
    require(len(K.KERNELS) == 8 and all(
        k.lib_path is not None and k.lib_path.exists()
        for k in K.KERNELS.values()), "eight kernels built")
    for k in K.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {k.name}: {line.strip()}")

    # ---- phase 3: each kernel against its plain version ---------------- #
    adj = delaunay_maxcut_adjacency(MAIN_N, seed=MAIN_SEED)
    cone = ConeOps(maxcut_problem_from_adjacency(adj).cones[0], dev)
    print(f"[problem] delaunay n={MAIN_N} seed={MAIN_SEED}: "
          f"{adj.nnz // 2} edges, C upper nnz {cone.c_nnz}, "
          f"full CSR nnz {cone.c_csr.nnz}", flush=True)
    report = {"maxcut": check_kernels(K, cone, dev)}

    t = time.perf_counter()
    mc_data = matcomp_sdpa(*MC_ARGS)
    mc_cone = ConeOps(canonicalize(mc_data).cones[0], dev)
    require((mc_cone.kind_a, mc_cone.kind_c) == ("sparse", "sparse")
            and not mc_cone.diag_identity, "matrix completion is a sparse cone")
    print(f"[problem] matcomp {MC_ARGS}: n={mc_cone.n} m={mc_cone.m} "
          f"A upper nnz {mc_cone.a_seg.nnz}, full CSR slots "
          f"{mc_cone.a_csr.nnz}, C nnz {mc_cone.c_nnz}, rank cap "
          f"{mc_cone.rank_max}, built in {time.perf_counter() - t:.1f} s",
          flush=True)
    report["matcomp"] = {
        **check_objective_kernels(K, mc_cone, dev, MC_CHECK_RANKS,
                                  MC_REPORT_RANK, "matcomp"),
        **check_general_kernels(K, mc_cone.a_seg, mc_cone.a_csr, dev,
                                MC_CHECK_RANKS, MC_REPORT_RANK, "matcomp")}
    trace_entries = trace_cone_entries()
    rows, cols, vals, cid, tn, tm = trace_entries
    check_general_kernels(
        K, K.SegCOO.from_coo(rows, cols, vals, cid, tn, tm, dev),
        K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, tn, tm, dev), dev,
        (19,), 19, "random+trace")
    check_long_segments(K, trace_entries, dev, 19, "random+trace")
    del mc_cone

    # the Lovasz theta cone at the width of Mittelmann theta12: dense C, one
    # 600-entry trace segment, one entry per edge
    check_dense_cone(K, canonicalize(theta_sdpa(*THETA12_ARGS)).cones[0],
                     dev, THETA12_RANKS, THETA12_RANKS[0],
                     f"theta12 {THETA12_ARGS}", relabel=True)

    # the cone that the theta main path solves, at the rank it starts from
    # (its rank cap, so it stays there) and r = 1: this is the path's row of
    # the kernels line
    th_data = theta_sdpa(THETA_N, THETA_N // 4, THETA_N)
    th_prob = canonicalize(th_data)
    require(initial_ranks(th_prob)[0] == [THETA_RANKS[0]],
            f"theta: the solve starts at rank {THETA_RANKS[0]}")
    report["theta"] = check_dense_cone(
        K, th_prob.cones[0], dev, THETA_RANKS, THETA_RANKS[0],
        f"theta{THETA_N}", relabel=True)

    # the multi-block + LP main path's shapes: K5 / K6 and the dense product
    # on each of its three blocks at the block's starting rank (the rank the
    # solve ends at) and r = 1, K7 / K8 on its LP cone and on one ten times
    # that; the largest block's row goes into the kernels line
    t = time.perf_counter()
    mb_data = multiblock_lp_sdpa(MB_DIMS, MB_M, MB_NLP, MB_SEED)
    mb_prob = canonicalize(mb_data)
    mb_ranks = initial_ranks(mb_prob)[0]
    require(mb_prob.n_lp_cols == MB_NLP and mb_ranks[0] == MB_REPORT_RANK,
            "multi-block + LP: an LP cone, block 0 starts at MB_REPORT_RANK")
    mb_lp = LPOps(mb_prob.lp, dev)
    print(f"[problem] multiblock+lp dims={MB_DIMS} m={MB_M} n_lp={MB_NLP} "
          f"seed={MB_SEED}: starting ranks {mb_ranks}, LP entries "
          f"{mb_lp.entries.nnz}, built in {time.perf_counter() - t:.1f} s",
          flush=True)
    mb_rows = [check_dense_cone(K, c, dev, (r, 1), r, f"multiblock[{k}]")
               for k, (c, r) in enumerate(zip(mb_prob.cones, mb_ranks))]
    report["multiblock_lp"] = {
        **mb_rows[0], **check_lp_kernels(K, mb_lp.entries, dev,
                                         "multiblock+lp")}
    big_lp = canonicalize(multiblock_lp_sdpa((2,), 10 * MB_M, 10 * MB_NLP,
                                             1)).lp
    check_lp_kernels(K, LPOps(big_lp, dev).entries, dev, "10x LP")
    del mb_lp, big_lp

    optimal = (SolverStatus.PRIMAL_DUAL_OPTIMAL, SolverStatus.PRIMAL_OPTIMAL)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 4: the MaxCut main path through the CLI ------------- #
        path = os.path.join(tmp, f"delaunay_n14_seed{MAIN_SEED}.mat")
        scipy.io.savemat(path, {"Problem": {"A": adj}})
        counts, _ = run_main_path("main", path, MAIN_FLAGS, MAXCUT_KERNELS,
                                  optimal[:1], (1e-5, 1e-5, 1e-5), dev)

        # ---- phase 5: the sparse-cone main path through the CLI -------- #
        path = os.path.join(tmp, f"mc{2 * MC_N1}.dat-s")
        t = time.perf_counter()
        write_sdpa(path, mc_data)
        print(f"[matcomp] wrote {os.path.getsize(path) / 1e6:.1f} MB .dat-s "
              f"in {time.perf_counter() - t:.1f} s", flush=True)
        mc_counts, _ = run_main_path("matcomp", path, MC_FLAGS,
                                     SPARSE_KERNELS, optimal,
                                     (1e-5, 5e-5, 5e-5), dev)

        # ---- phase 6: the multi-block + LP main path through the CLI --- #
        path = os.path.join(tmp, "multiblock_lp.dat-s")
        t = time.perf_counter()
        write_sdpa(path, mb_data)
        print(f"[multiblock_lp] wrote {os.path.getsize(path) / 1e6:.1f} MB "
              f".dat-s in {time.perf_counter() - t:.1f} s", flush=True)
        mb_counts, mb_res = run_main_path(
            "multiblock_lp", path, (), MB_KERNELS, optimal,
            (1e-5, 5e-5, 5e-5), dev, n_blocks=len(MB_DIMS))
        for k, (c, r0, r) in enumerate(zip(mb_prob.cones, mb_ranks,
                                           mb_res.final_ranks)):
            if r != r0:     # a rank the solve grew to: hold the kernels there
                check_dense_cone(K, c, dev, (r,), r, f"multiblock[{k}] final")

        # ---- phase 7: the Lovasz theta path through the CLI ------------ #
        path = os.path.join(tmp, f"theta{THETA_N}.dat-s")
        write_sdpa(path, th_data)
        th_counts, th_res = run_main_path(
            "theta", path, ("--timeSecLimit", str(THETA_LIMIT_S)),
            DENSE_KERNELS, optimal, (1e-5, 5e-5, 5e-5), dev, repeat=False)
        require(th_res.solve_time <= THETA_LIMIT_S,
                f"theta: the solve took more than {THETA_LIMIT_S} s")
        if th_res.final_ranks[0] not in THETA_RANKS:
            check_dense_cone(K, th_prob.cones[0], dev, th_res.final_ranks,
                             th_res.final_ranks[0], f"theta{THETA_N} final",
                             relabel=True)

    # ---- phase 8: GPU and CPU agree on small problems ------------------ #
    for tag, small, params in (
            ("g11", random_maxcut_problem(800, avg_degree=4, seed=11),
             SolverParams()),
            ("mc400", matcomp_problem(*MC_SMALL_ARGS),
             SolverParams(heuristic_factor=10.0)),
            ("multiblock-gs", random_multiblock_problem(), SolverParams()),
            ("multiblock-jacobi", random_multiblock_problem(),
             SolverParams(admm_jacobi=True)),
            ("multiblock_lp-small", multiblock_lp_problem(**MB_SMALL),
             SolverParams()),
            ("theta80", theta_problem(80, 20, 80), SolverParams())):
        t = time.perf_counter()
        r_gpu = Solver(small, params, device=dev).solve()
        t_gpu = time.perf_counter() - t
        t = time.perf_counter()
        r_cpu = Solver(small, params, device="cpu").solve()
        t_cpu = time.perf_counter() - t
        for side, r, secs in (("gpu", r_gpu, t_gpu), ("cpu", r_cpu, t_cpu)):
            print(f"[{tag}] {side} {r.status.value} pobj {r.pobj:.12e} gap "
                  f"{r.gap:.2e} ranks {r.final_ranks} ALM outer "
                  f"{r.alm_outer_iters} inner {r.alm_inner_iters} ADMM "
                  f"{r.admm_iters} {secs:.2f} s", flush=True)
        require(r_gpu.status == r_cpu.status and r_gpu.status in optimal,
                f"{tag}: GPU and CPU status differ")
        require(r_gpu.final_ranks == r_cpu.final_ranks,
                f"{tag}: GPU and CPU ranks differ")
        count_fields = ("alm_outer_iters", "alm_inner_iters", "admm_iters")
        same_counts = all(getattr(r_gpu, f) == getattr(r_cpu, f)
                          for f in count_fields)
        diff, tol = abs(r_gpu.pobj - r_cpu.pobj), 1e-6 * abs(r_cpu.pobj)
        print(f"[{tag}] |pobj gpu - pobj cpu| {diff:.3e}, bound {tol:.3e} "
              f"(1e-6 relative), counts "
              f"{'agree' if same_counts else 'differ'}", flush=True)
        if diff <= tol:
            continue
        # Only two solves that parted in a reopt round may end further apart
        # (one stops just under the gap tolerance, the other goes one round
        # on).  They are held to 1e-6 where both still walk the same path,
        # at the end of the main ALM and ADMM phases (reopt_level=0, whatever
        # status that point has), with the same counts there.  That the two
        # full solves lie within their own certified gaps is a second,
        # weaker check.
        require(not same_counts,
                f"{tag}: GPU and CPU pobj differ with the same counts")
        main_only = dataclasses.replace(params, reopt_level=0)
        m_gpu = Solver(small, main_only, device=dev).solve()
        m_cpu = Solver(small, main_only, device="cpu").solve()
        m_diff = abs(m_gpu.pobj - m_cpu.pobj)
        m_tol = 1e-6 * abs(m_cpu.pobj)
        print(f"[{tag}] main phases only (reopt_level=0): gpu "
              f"{m_gpu.status.value} pobj {m_gpu.pobj:.12e} ALM outer "
              f"{m_gpu.alm_outer_iters} inner {m_gpu.alm_inner_iters} ADMM "
              f"{m_gpu.admm_iters}; cpu pobj {m_cpu.pobj:.12e} ALM outer "
              f"{m_cpu.alm_outer_iters} inner {m_cpu.alm_inner_iters} ADMM "
              f"{m_cpu.admm_iters}; |pobj gpu - pobj cpu| {m_diff:.3e}, "
              f"bound {m_tol:.3e} (1e-6 relative)", flush=True)
        require(m_gpu.status == m_cpu.status
                and m_gpu.final_ranks == m_cpu.final_ranks
                and all(getattr(m_gpu, f) == getattr(m_cpu, f)
                        for f in count_fields),
                f"{tag}: GPU and CPU part before the reopt rounds")
        require(m_diff <= m_tol,
                f"{tag}: GPU and CPU pobj differ before the reopt rounds")
        gaps = (r_gpu.gap + r_cpu.gap) * (
            1.0 + abs(r_cpu.pobj) + abs(r_cpu.dobj))
        print(f"[{tag}] full solves: |pobj gpu - pobj cpu| {diff:.3e}, the "
              f"two certified gaps allow {gaps:.3e}", flush=True)
        require(diff <= gaps + tol,
                f"{tag}: GPU and CPU pobj differ by more than their gaps")

    # ---- phase 9: report ---------------------------------------------- #
    # one row per kernel, measured at the shapes of the path that first
    # carried it (MaxCut for K1-K4, the sparse cone for K5 and K6, the
    # multi-block + LP problem for K7 and K8); under "by_path" the same
    # fields for every main path that launches it, each measured at that
    # path's shapes with that path's launch count
    path_counts = {"maxcut": counts, "matcomp": mc_counts,
                   "multiblock_lp": mb_counts, "theta": th_counts}
    first_path = {**{name: "matcomp" for name in SPARSE_KERNELS},
                  **{name: "maxcut" for name in MAXCUT_KERNELS},
                  "lp_constr_segsum": "multiblock_lp",
                  "lp_col_wsum": "multiblock_lp"}
    kernels = []
    for name, k in K.KERNELS.items():
        by_path = {path: {"launches": path_counts[path][name][0], **rows[name]}
                   for path, rows in report.items() if name in rows}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": k.replaces,
            **by_path[first_path[name]],
            "by_path": by_path})
    for row in UNPORTED:
        print(f"[unported] {row}")
    for row in LOOPS:
        print(f"[loop, plain torch over the kernels] {row}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
