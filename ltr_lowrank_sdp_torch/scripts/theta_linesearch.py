"""The ALM line search on the card against the host's, on a theta solve's
own coefficients, step by step.

The device-resident inner pass takes its step from
``ops.cubic.quartic_argmin_t`` (branch-free, PyTorch's CUDA cube roots and
trigonometric functions); the eager pass of earlier versions took it from
``quartic_argmin`` in host float64 (the host's libm).  This script solves
``theta_sdpa(N, N // 4, N)`` (``chip_smoke.py``'s theta path, with the
CLI's parameters) three times on the card:

* ``graphs``: the solver as it runs (the device-resident loops, replayed
  CUDA graphs): its counts;
* ``device``: the eager inner pass, each step taking the device's root and
  recording the host's on the same coefficients;
* ``host``: the eager inner pass, each step taking the host's root and
  recording the device's.

For each eager run: its counts, the steps, the steps whose two roots
differ, by how many units in the last place (ulp) and in which root count,
and the first such step (its index, outer iteration and values).  Then the
first step at which the ``device`` and ``host`` runs take another tau:
where the two paths part.  One JSON line; ``--out FILE`` also writes every
step's record there.  ``--against-exact FILE`` (on the CPU) reads those
records back and holds both roots of every step where they differ against
the exact minimizer, from the roots of phi' at 60 digits (mpmath).

    python -m ltr_lowrank_sdp_torch.scripts.theta_linesearch [--n 300] [--out FILE]
    python -m ltr_lowrank_sdp_torch.scripts.theta_linesearch --against-exact FILE
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from ..ops.cubic import quartic_argmin


def ulp_distance(a: float, b: float) -> int:
    """Units in the last place between two float64 values (0 when equal,
    -1 when their signs differ)."""
    if a == b:
        return 0
    if (a < 0) != (b < 0):
        return -1
    ia, ib = (int(np.float64(x).view(np.int64)) for x in (a, b))
    return abs(ia - ib)


def _recording(mode: str, log: list, outer: list):
    """A ``quartic_step`` that returns the ``mode`` side's root and logs
    both."""
    from ..ops import cubic

    device_step = cubic.quartic_step

    def step(coef, tau_max):
        tau_d, root_d = device_step(coef, tau_max)
        a, b, c, d = coef.double().tolist()
        tm = float(tau_max)
        tau_h, root_h = quartic_argmin(a, b, c, d, tau_max=tm)
        log.append((outer[0], a, b, c, d, tm, float(tau_d), int(root_d),
                    tau_h, root_h))
        if mode == "device":
            return tau_d, root_d
        return (torch.tensor(tau_h, dtype=torch.float64, device=coef.device),
                torch.tensor(root_h, dtype=torch.int64, device=coef.device))
    return step


def _bucket(u: int) -> str:
    return ("sign" if u < 0 else "0" if u == 0 else "1" if u == 1
            else "2-15" if u < 16 else "16-2^20" if u < 2 ** 20
            else ">=2^20")


def exact_argmin(a, b, c, d, tau_max) -> float:
    """The minimizer of phi on [0, tau_max] at 60 digits, rounded to
    float64 (0, tau_max and the real critical points inside)."""
    import mpmath

    with mpmath.workdps(60):
        a, b, c, d, tm = (mpmath.mpf(x) for x in (a, b, c, d, tau_max))

        def phi(x):
            return ((a * x + b) * x + c) * x * x + d * x

        roots = mpmath.polyroots([4 * a, 3 * b, 2 * c, d], maxsteps=200,
                                 extraprec=200)
        tiny = mpmath.mpf(10) ** -40
        cands = [mpmath.mpf(0), tm] + [r.real for r in roots
                                       if abs(r.imag) < tiny
                                       and 0 < r.real <= tm]
        return float(min(cands, key=phi))


def against_exact(path: str) -> dict:
    """Each run's steps where the two roots differ, both against the exact
    minimizer: the ulp histogram of each and which lies closer."""
    with open(path) as f:
        logs = json.load(f)
    out = {}
    for mode, log in logs.items():
        dev, host, closer = Counter(), Counter(), Counter()
        for rec in log:
            if rec[6] == rec[8]:
                continue
            ex = exact_argmin(*rec[1:6])
            ud, uh = ulp_distance(rec[6], ex), ulp_distance(rec[8], ex)
            dev[_bucket(ud)] += 1
            host[_bucket(uh)] += 1
            closer["device" if ud < uh else "host" if uh < ud
                   else "tie"] += 1
        out[mode] = {"differing": sum(closer.values()),
                     "device_vs_exact": dict(dev),
                     "host_vs_exact": dict(host), "closer": dict(closer)}
    return out


def _counts(res) -> dict:
    return {"status": res.status.value, "alm_outer": res.alm_outer_iters,
            "alm_inner": res.alm_inner_iters, "admm": res.admm_iters,
            "cg": res.cg_iters, "final_ranks": list(res.final_ranks),
            "pobj": res.pobj, "solve_s": round(res.solve_time, 3)}


def _summary(log: list) -> dict:
    diff = [(k, rec) for k, rec in enumerate(log)
            if rec[6] != rec[8] or rec[7] != rec[9]]
    ulps = Counter()
    roots = Counter()
    for _, rec in diff:
        ulps[_bucket(ulp_distance(rec[6], rec[8]))] += 1
        if rec[7] != rec[9]:
            roots[f"{rec[9]}->{rec[7]}"] += 1
    out = {"steps": len(log), "steps_differing": len(diff),
           "ulp_histogram": dict(ulps), "root_count_changes": dict(roots)}
    if diff:
        k, rec = diff[0]
        out["first"] = {"step": k, "outer": rec[0],
                        "coef": list(rec[1:5]), "tau_max": rec[5],
                        "tau_device": rec[6], "tau_host": rec[8],
                        "ulp": ulp_distance(rec[6], rec[8]),
                        "roots_device_host": [rec[7], rec[9]]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--out", default=None)
    ap.add_argument("--against-exact", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    if args.against_exact:
        print(json.dumps(against_exact(args.against_exact)), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("theta_linesearch: no CUDA device is available",
              file=sys.stderr)
        return 2
    from .. import cli
    from ..ops import kernels as K
    from ..problem import load_problem
    from ..solver import alm as alm_mod
    from ..solver.driver import Solver
    from ..testing import theta_sdpa, write_sdpa

    K.build_kernels()
    n = args.n
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"theta{n}.dat-s")
        write_sdpa(path, theta_sdpa(n, n // 4, n))
        prob = load_problem(path)
        params = cli.params_from_args(
            cli.build_arg_parser().parse_args([path]))
    out = {"n": n}
    t = time.perf_counter()
    out["graphs"] = _counts(Solver(prob, params).solve())
    logs = {}
    run_outer = alm_mod.ALMPhase.outer_step
    run_step = alm_mod.quartic_step
    for mode in ("device", "host"):
        log, outer = [], [0]

        def outer_step(self, *a, **k):
            outer[0] += 1
            return run_outer(self, *a, **k)

        alm_mod.quartic_step = _recording(mode, log, outer)
        alm_mod.ALMPhase.outer_step = outer_step
        try:
            solver = Solver(prob, params)
            solver.device_loops = False
            out[mode] = {**_counts(solver.solve()), **_summary(log)}
        finally:
            alm_mod.quartic_step = run_step
            alm_mod.ALMPhase.outer_step = run_outer
        logs[mode] = log
    a, b = logs["device"], logs["host"]
    part = next((k for k, (x, y) in enumerate(zip(a, b)) if x[6] != y[8]
                 or x[1:6] != y[1:6]), None)
    out["paths_part_at_step"] = part
    if part is not None:
        out["parting"] = {"outer": a[part][0],
                          "same_coefficients": a[part][1:6] == b[part][1:6],
                          "tau_device_run": a[part][6],
                          "tau_host_run": b[part][8]}
    out["seconds"] = round(time.perf_counter() - t, 1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({m: logs[m] for m in logs}, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
