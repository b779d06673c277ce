#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits nonzero:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; no CUDA device -> exit 2 before anything else;
2. build the six CUDA kernels from ``ltr_lowrank_sdp_torch/csrc`` (nvcc,
   sm_90a, all sources at once);
3. hold each kernel against its plain PyTorch version on the card, in
   float64, at the main paths' shapes: max relative error <= 1e-12, with the
   kernel's time, the plain version's time, the memory bound (bytes / 3.35
   TB/s) and, for the two SpMMs, one ``torch.sparse.mm`` call as a yardstick
   that the port never calls.  K1-K4 on the n = 2^14 Delaunay MaxCut C at
   rank 20 and 64; on the n = 10^4 matrix-completion cone at rank 19 and 64,
   K1 (C = I scaled by the objective coefficient, no diagonal term, also at
   r = 1 and chained into K6 as ``apply_w`` does), K4 (U, V and ``U is V``
   on the 10^4 diagonal entries), K5 (single, ``U is V``, pair) and K6
   (alone, with an addend, r = 1, weights with zeros); K5 and K6 once more
   on a random sparse cone with several entries per constraint and a
   trace-like constraint of n entries;
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
6. GPU against CPU on a G11-sized random MaxCut (n = 800) and on a small
   matrix completion (n = 400): same status and ranks, pobj equal to 1e-6;
7. the ``kernels`` JSON line (each kernel's row, and under ``by_path`` its
   row at every main path's shapes), the kernels still to be ported, the
   solver loops carried as plain torch over the kernels, the card line
   and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
SLEEP_CYCLES = 50_000_000  # about 30 ms at the H100's clocks

UNPORTED = [
    "P  scripts/pallas_gather_probe.py:40-65 kern (pallas_call :57): "
    "gather-sum probe; later an H100 gather micro-benchmark",
    "10 ltr_lowrank_sdp_tpu/ops/coneops.py:435,443 LPOps.constr_vals, "
    "weighted_col_sums (LP slice)",
    "14 ltr_lowrank_sdp_tpu/models/gatv2.py:26,94 segment_softmax, "
    "segment_sum; layers.py:93-99; net.py:90-93 (ML slice)",
    "15 ltr_lowrank_sdp_tpu/hallar/solver.py:179,188 _Ops.AX, _Ops.SY "
    "(HALLaR slice)",
    "16 ltr_lowrank_sdp_tpu/parallel/meshops.py:211,220 _local_reduce, "
    "_local_spmm (parallel slice)",
]
# The reference's device-resident solver loops are jnp loops over the
# operators above, with no gather or segment-reduction kernel of their own;
# the port carries them as plain torch loops over K1-K6.  A fused or
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
        require(rel_err(kern(), lib()) <= KERNEL_RTOL,
                f"{name} {tag}: library result differs")
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


def trace_cone_layouts(K, dev, n=4096, m=8192, nnz_per=4, seed=3):
    """K5 / K6 layouts of a random sparse cone with ``nnz_per`` entries per
    constraint (repeats and diagonal entries included), one constraint with
    no entry, and a last, trace-like constraint of n diagonal entries."""
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
    return (K.SegCOO.from_coo(rows, cols, vals, cid, n, m + 1, dev),
            K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, n, m + 1, dev))


def run_main_path(tag, path, flags, launched, statuses, limits, dev):
    """Drive one main path through the CLI with the launch counters set to 0
    just before and read just after, check the result by the repo's own
    means, then solve again warm and once under the profiler.  Returns the
    counts of the CLI run."""
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
    prob = load_problem(path)
    Ravg = tuple(0.5 * (u + v) for u, v in zip(res.U, res.V))
    pobj, dobj, pinf, pinf_inf, gap = host_metrics_f64(
        prob, Ravg, Ravg, None, None, res.dual, res.obj_scale)
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
    return counts


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    import scipy.io

    from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps
    from ltr_lowrank_sdp_torch.problem import canonicalize
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                               matcomp_problem, matcomp_sdpa,
                                               random_maxcut_problem,
                                               write_sdpa)

    dev = torch.device("cuda", torch.cuda.current_device())

    # ---- phase 2: build ------------------------------------------------ #
    t = time.perf_counter()
    built = K.build_kernels()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t:.1f} s "
          f"({', '.join(built)})")
    require(len(K.KERNELS) == 6 and all(
        k.lib_path is not None and k.lib_path.exists()
        for k in K.KERNELS.values()), "six kernels built")
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
    check_general_kernels(K, *trace_cone_layouts(K, dev), dev, (19,), 19,
                          "random+trace")
    del mc_cone

    optimal = (SolverStatus.PRIMAL_DUAL_OPTIMAL, SolverStatus.PRIMAL_OPTIMAL)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 4: the MaxCut main path through the CLI ------------- #
        path = os.path.join(tmp, f"delaunay_n14_seed{MAIN_SEED}.mat")
        scipy.io.savemat(path, {"Problem": {"A": adj}})
        counts = run_main_path("main", path, MAIN_FLAGS, MAXCUT_KERNELS,
                               optimal[:1], (1e-5, 1e-5, 1e-5), dev)

        # ---- phase 5: the sparse-cone main path through the CLI -------- #
        path = os.path.join(tmp, f"mc{2 * MC_N1}.dat-s")
        t = time.perf_counter()
        write_sdpa(path, mc_data)
        print(f"[matcomp] wrote {os.path.getsize(path) / 1e6:.1f} MB .dat-s "
              f"in {time.perf_counter() - t:.1f} s", flush=True)
        mc_counts = run_main_path("matcomp", path, MC_FLAGS, SPARSE_KERNELS,
                                  optimal, (1e-5, 5e-5, 5e-5), dev)

    # ---- phase 6: GPU and CPU agree on small problems ------------------ #
    for tag, small, params in (
            ("g11", random_maxcut_problem(800, avg_degree=4, seed=11),
             SolverParams()),
            ("mc400", matcomp_problem(*MC_SMALL_ARGS),
             SolverParams(heuristic_factor=10.0))):
        t = time.perf_counter()
        r_gpu = Solver(small, params, device=dev).solve()
        t_gpu = time.perf_counter() - t
        t = time.perf_counter()
        r_cpu = Solver(small, params, device="cpu").solve()
        t_cpu = time.perf_counter() - t
        print(f"[{tag}] gpu {r_gpu.status.value} pobj {r_gpu.pobj:.12e} "
              f"ranks {r_gpu.final_ranks} ALM inner {r_gpu.alm_inner_iters} "
              f"{t_gpu:.2f} s; cpu {r_cpu.status.value} pobj "
              f"{r_cpu.pobj:.12e} ranks {r_cpu.final_ranks} ALM inner "
              f"{r_cpu.alm_inner_iters} {t_cpu:.2f} s", flush=True)
        require(r_gpu.status == r_cpu.status and r_gpu.status in optimal,
                f"{tag}: GPU and CPU status differ")
        require(r_gpu.final_ranks == r_cpu.final_ranks,
                f"{tag}: GPU and CPU ranks differ")
        require(abs(r_gpu.pobj - r_cpu.pobj) <= 1e-6 * abs(r_cpu.pobj),
                f"{tag}: GPU and CPU pobj differ")

    # ---- phase 7: report ---------------------------------------------- #
    # one row per kernel, measured at the shapes of the path that first
    # carried it (MaxCut for K1-K4, the sparse cone for K5 and K6); under
    # "by_path" the same fields for every main path that launches it, each
    # measured at that path's shapes with that path's launch count
    path_counts = {"maxcut": counts, "matcomp": mc_counts}
    kernels = []
    for name, k in K.KERNELS.items():
        by_path = {path: {"launches": path_counts[path][name][0], **rows[name]}
                   for path, rows in report.items() if name in rows}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": k.replaces,
            **by_path["maxcut" if name in MAXCUT_KERNELS else "matcomp"],
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
