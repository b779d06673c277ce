#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits nonzero:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; no CUDA device -> exit 2 before anything else;
2. build the four CUDA kernels from ``ltr_lowrank_sdp_torch/csrc`` (nvcc,
   sm_90a, all sources at once);
3. hold each kernel against its plain PyTorch version on the card, in
   float64, at the main path's shapes (the n = 2^14 Delaunay MaxCut C, rank
   20 and 64): max relative error <= 1e-12, with the kernel's time, the plain
   version's time, the memory bound (bytes / 3.35 TB/s) and, for the SpMM,
   one ``torch.sparse.mm`` call as a yardstick that the port never calls;
4. the main path: ``ltr_lowrank_sdp_torch.cli.main`` on the Delaunay graph
   (n = 2^14, seed 14; the kind of SuiteSparse ``delaunay_n14``, solved with
   the LoRADS MaxCut row's flags ``--phase1Tol 1e+1 --heuristicFactor
   100``), with every launch counter set to 0 just before and read just
   after: status primal_dual_optimal, DIMACS errors <= 1e-5 (primal
   infeasibility and gap recomputed in float64 on the host), the trajectory
   JSON, and every kernel launched with no plain version run;
5. a G11-sized random MaxCut (n = 800) solved on the GPU and on the CPU:
   same status and ranks, pobj equal to 1e-6;
6. the ``kernels`` JSON line, the kernels still to be ported, the card line
   and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
SLEEP_CYCLES = 50_000_000  # about 30 ms at the H100's clocks

UNPORTED = [
    "P  scripts/pallas_gather_probe.py:40-65 kern (pallas_call :57): "
    "gather-sum probe; later an H100 gather micro-benchmark",
    "7  ltr_lowrank_sdp_tpu/ops/gatherseg.py:143 EllSegSum.__call__: "
    "segment sum (non-identity diag, sparse A, LP)",
    "8  ltr_lowrank_sdp_tpu/ops/gatherseg.py:256 EllSpMM.apply_constr: "
    "(sum_i w_i A_i) Y (sparse-A slice)",
    "9  ltr_lowrank_sdp_tpu/ops/coneops.py:239-330 sparse/non-identity "
    "constr_vals, constr_vals_pair, cg_normal_matvec (sparse-A slice)",
    "10 ltr_lowrank_sdp_tpu/ops/coneops.py:435,443 LPOps.constr_vals, "
    "weighted_col_sums (LP slice)",
    "11 ltr_lowrank_sdp_tpu/ops/cg.py:31, ops/lanczos.py:23 cg_solve, "
    "lanczos_tridiag: plain torch loops over K1-K3 here; fused later",
    "12 ltr_lowrank_sdp_tpu/ops/lbfgs.py:71,48 direction, push_pair: "
    "plain torch here; kernel later",
    "13 ltr_lowrank_sdp_tpu/ops/lanczos.py:162 oracle_rank_gram: "
    "torch.matmul + host eigh here",
    "14 ltr_lowrank_sdp_tpu/models/gatv2.py:26,94 segment_softmax, "
    "segment_sum; layers.py:93-99; net.py:90-93 (ML slice)",
    "15 ltr_lowrank_sdp_tpu/hallar/solver.py:179,188 _Ops.AX, _Ops.SY "
    "(HALLaR slice)",
    "16 ltr_lowrank_sdp_tpu/parallel/meshops.py:211,220 _local_reduce, "
    "_local_spmm (parallel slice)",
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


def profile_solve(solver) -> None:
    """One solve under ``torch.profiler``: device busy share of the wall
    time and the kernels that take it."""
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
    print(f"[profile] solve wall {wall:.3f} s under the profiler, device "
          f"busy {busy:.4f} s ({100 * busy / wall:.1f} %), "
          f"{len(kernels)} device kernels")
    for name, (c, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:12]:
        print(f"[profile] {us / 1e3:9.3f} ms {c:6d} x {name[:90]}")


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
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            out_k = out_k if isinstance(out_k, tuple) else (out_k,)
            out_p = out_p if isinstance(out_p, tuple) else (out_p,)
            rel = max(rel_err(a, b) for a, b in zip(out_k, out_p))
            abs_err = max(float((a - b).abs().max())
                          for a, b in zip(out_k, out_p))
            for kx, px in extra[name]:
                a, b = kx(), px()
                torch.cuda.synchronize()
                rel = max(rel, rel_err(a, b))
            require(rel <= KERNEL_RTOL,
                    f"{name} r={r}: rel err {rel:.3e} > {KERNEL_RTOL}")
            ms = time_ms(kern)
            plain_ms = time_ms(plain)
            call_ms = host_call_ms(kern)
            lib_ms = time_ms(lib) if lib is not None else None
            if lib is not None:
                require(rel_err(kern(), lib()) <= KERNEL_RTOL,
                        f"{name} r={r}: library result differs")
            b_ms, b_by = bound_ms(nbytes, flops)
            lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "null"
            print(f"[kernel] {name} n={n} r={r}: max rel err {rel:.2e} "
                  f"(tol {KERNEL_RTOL:g}), max abs err {abs_err:.2e}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), library {lib_txt} ms, "
                  f"{nbytes / ms / 1e6:.1f} GB/s; host-issued call "
                  f"{call_ms:.4f} ms", flush=True)
            if r == REPORT_RANK:
                report[name] = {"max_abs_err": abs_err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": lib_ms}
    return report


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

    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.config import SolverStatus
    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps
    from ltr_lowrank_sdp_torch.problem import load_problem
    from ltr_lowrank_sdp_torch.solver.common import host_metrics_f64
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                               random_maxcut_problem)

    dev = torch.device("cuda", torch.cuda.current_device())

    # ---- phase 2: build ------------------------------------------------ #
    t = time.perf_counter()
    built = K.build_kernels()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t:.1f} s "
          f"({', '.join(built)})")
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
    report = check_kernels(K, cone, dev)

    # ---- phase 4: the main path through the CLI ------------------------ #
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"delaunay_n14_seed{MAIN_SEED}.mat")
        scipy.io.savemat(path, {"Problem": {"A": adj}})
        jpath = os.path.join(tmp, "solution.json")
        K.reset_counts()
        t = time.perf_counter()
        res = cli.main([path, *MAIN_FLAGS, "--jsonfile", jpath])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = K.counts()
        print(f"[main] counts {json.dumps(counts)}")
        print(f"[main] cli wall {wall:.3f} s, solve {res.solve_time:.3f} s, "
              f"stages {json.dumps({k: round(v, 4) for k, v in res.stage_times.items()})}")
        print(f"[main] ALM outer {res.alm_outer_iters} inner "
              f"{res.alm_inner_iters}, ADMM {res.admm_iters}, CG total "
              f"{res.cg_iters}, host syncs {res.host_syncs}, final ranks "
              f"{res.final_ranks}", flush=True)
        for name, (launches, plain_calls) in counts.items():
            require(launches > 0, f"{name} was not launched on the main path")
            require(plain_calls == 0,
                    f"{name}'s plain version ran on the main path")
        require(res.status == SolverStatus.PRIMAL_DUAL_OPTIMAL,
                f"status {res.status.value}")
        prob = load_problem(path)
        Ravg = tuple(0.5 * (u + v) for u, v in zip(res.U, res.V))
        pobj, dobj, pinf, pinf_inf, gap = host_metrics_f64(
            prob, Ravg, Ravg, None, None, res.dual, res.obj_scale)
        print(f"[main] host f64: pobj {pobj:.10e} dobj {dobj:.10e} "
              f"pinf_l1 {pinf:.3e} gap {gap:.3e}; solver dinf_l1 "
              f"{res.dinf_l1:.3e}")
        require(pinf <= 1e-5 and gap <= 1e-5 and res.dinf_l1 <= 1e-5,
                "DIMACS errors above 1e-5")
        require(abs(pobj - res.pobj) <= 1e-8 * abs(pobj),
                "device pobj disagrees with the host recomputation")
        with open(jpath) as f:
            payload = json.load(f)
        require(set(payload) == {"problem_id", "file_path", "metrics",
                                 "trajectory"}, "trajectory JSON keys")
        require(set(payload["trajectory"]) == {"phase_1", "phase_2"},
                "trajectory phases")

        # the same solve again, warm, then once more under the profiler
        params = cli.params_from_args(cli.build_arg_parser().parse_args(
            [path, *MAIN_FLAGS]))
        solver = Solver(prob, params, device=dev)
        t = time.perf_counter()
        warm = solver.solve()
        torch.cuda.synchronize()
        print(f"[main] warm solve {time.perf_counter() - t:.3f} s "
              f"(status {warm.status.value}, ADMM {warm.admm_iters})")
        profile_solve(solver)

    # ---- phase 5: GPU and CPU agree on a G11-sized problem ------------- #
    small = random_maxcut_problem(800, avg_degree=4, seed=11)
    t = time.perf_counter()
    r_gpu = Solver(small, device=dev).solve()
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    r_cpu = Solver(small, device="cpu").solve()
    t_cpu = time.perf_counter() - t
    print(f"[g11] gpu {r_gpu.status.value} pobj {r_gpu.pobj:.12e} ranks "
          f"{r_gpu.final_ranks} {t_gpu:.2f} s; cpu {r_cpu.status.value} pobj "
          f"{r_cpu.pobj:.12e} ranks {r_cpu.final_ranks} {t_cpu:.2f} s")
    require(r_gpu.status == r_cpu.status, "GPU and CPU status differ")
    require(r_gpu.final_ranks == r_cpu.final_ranks,
            "GPU and CPU ranks differ")
    require(abs(r_gpu.pobj - r_cpu.pobj) <= 1e-6 * abs(r_cpu.pobj),
            "GPU and CPU pobj differ")

    # ---- phase 6: report ---------------------------------------------- #
    kernels = []
    for name, k in K.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": k.replaces, "launches": counts[name][0],
            **report[name]})
    for row in UNPORTED:
        print(f"[unported] {row}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
