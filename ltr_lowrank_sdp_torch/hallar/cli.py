"""HALLaR solver CLI of the PyTorch port: the interface of
``ltr_lowrank_sdp_tpu/hallar/cli.py`` (itself the reference binary's,
``hallar/src/README.md:40-75``) plus ``--device``.

Usage:
    python -m ltr_lowrank_sdp_torch.hallar.cli -i problem.dat-s --trace_bound 10
    python -m ltr_lowrank_sdp_torch.hallar.cli -i problem.hslr -c options.cfg -o out.json
    python -m ltr_lowrank_sdp_torch.hallar.cli --run_tests --device cpu

The solve runs on ``cuda:0`` unless ``--device cpu`` is given; without a GPU
and without ``--device cpu`` it stops with an error.  ``--run_tests`` solves
the built-in spectraplex problems (the binary's bundled example files are not
part of this repository) and prints the binary's success lines ("All HSLR
tests passed" / "All SDPA tests passed").
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .. import resolve_device

# options.cfg key -> HallarParams field (keys without a mapping are accepted
# and ignored, like the binary ignores options for solvers it doesn't run)
_CFG_KEYS = {
    "time_limit": ("time_limit", float),
    "maxiter_fista": ("maxiter_fista", int),
    "L0_fista": ("L0_fista", float),
    "L_inc_fista": ("L_inc_fista", float),
    "err_tol_fista": ("err_tol_fista", float),
    "maxiter_hallar": ("maxiter_hallar", int),
    "eps_pfeas": ("eps_pfeas", float),
    "eps_gap": ("eps_gap", float),
    "beta0": ("beta0", float),
    "beta_inc": ("beta_inc", float),
    "beta_min": ("beta_min", float),
    "beta_max": ("beta_max", float),
    "trace_bound": ("_trace_bound", float),   # handled by the caller
    "err_tol_eig": ("escape_tol", float),
    "inner_solver": ("inner_solver", str),    # "fista" | "aipp"
    "aipp_lambda0": ("aipp_lambda0", float),
    "aipp_max_prox": ("aipp_max_prox", int),
    "aipp_rho": ("aipp_rho", float),
}


def read_options_cfg(path: str) -> dict:
    """Parse the key=value option file (comments with '#', blank lines ok).

    Returns a dict of raw key -> string value; mapping onto HallarParams
    happens in :func:`params_from_cfg`.
    """
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def params_from_cfg(cfg: dict, **overrides):
    """Build HallarParams from a parsed options dict (+ CLI overrides).

    Returns (params, trace_bound_or_None)."""
    from .solver import HallarParams

    kw = {}
    trace_bound = None
    for key, raw in cfg.items():
        spec = _CFG_KEYS.get(key)
        if spec is None:
            continue
        field, conv = spec
        if field == "_trace_bound":
            trace_bound = conv(raw)
        else:
            kw[field] = conv(raw)
    kw.update(overrides)
    return HallarParams(**kw), trace_bound


def _is_hybrid_sdpa(path: str) -> bool:
    """Labeled hybrid SDPA variant (header lines like "m = 4")."""
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            return "=" in ln
    return False


def _load_problem(path: str, trace_bound):
    from ..problem import load_problem
    from .solver import SpectraplexProblem

    if path.endswith(".hslr"):
        return SpectraplexProblem.from_hslr(path)
    if _is_hybrid_sdpa(path):
        from ..io.hslr import read_hybrid_sdpa

        return SpectraplexProblem.from_hslr_data(
            read_hybrid_sdpa(path), tau=trace_bound)
    prob = load_problem(path)
    if trace_bound is None:
        raise SystemExit("--trace_bound (or trace_bound= in the options "
                         "file) is required for SDPA inputs")
    return SpectraplexProblem.from_sdp_problem(prob, trace_bound)


def run_tests(device=None) -> int:
    """Self-test mode (reference ``--run_tests``, README:56-69) on the
    built-in problem, once as the HSLR case and once as the SDPA case."""
    from .solver import HallarParams, hallar_solve

    print("Running tests")
    params = HallarParams(eps_pfeas=1e-5, eps_gap=1e-5, time_limit=300.0)
    hslr_ok = hallar_solve(_builtin_hslr_problem(), params,
                           device=device).converged
    print("[ Info: All HSLR tests passed ]" if hslr_ok
          else "[ Error: HSLR tests FAILED ]")
    sdpa_ok = hallar_solve(_builtin_sdpa_problem(), params,
                           device=device).converged
    print("[ Info: All SDPA tests passed ]" if sdpa_ok
          else "[ Error: SDPA tests FAILED ]")
    return 0 if (hslr_ok and sdpa_ok) else 1


def _builtin_hslr_problem():
    """Tiny feasible spectraplex problem with a known optimum."""
    from .solver import SpectraplexProblem

    n = 4
    rng = np.random.default_rng(0)
    G = rng.normal(size=(n, 2))
    C = G @ G.T + np.eye(n)
    iu = np.triu_indices(n)
    return SpectraplexProblem(
        n=n, m=1, b=np.array([1.0]), tau=2.0,
        c_rows=iu[0].astype(np.int32), c_cols=iu[1].astype(np.int32),
        c_vals=C[iu],
        a_rows=np.arange(n, dtype=np.int32),
        a_cols=np.arange(n, dtype=np.int32),
        a_vals=np.ones(n), a_cid=np.zeros(n, dtype=np.int32),
    )


_builtin_sdpa_problem = _builtin_hslr_problem


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hallar-torch",
        description="HALLaR-class spectraplex solver (PyTorch / CUDA)")
    ap.add_argument("-i", "--input", default=None,
                    help="SDPA (.dat-s) or HSLR (.hslr) problem file")
    ap.add_argument("-c", "--config", default=None,
                    help="key=value options file (examples/options.cfg)")
    ap.add_argument("-o", "--output", default=None,
                    help="JSON result output path")
    ap.add_argument("--trace_bound", type=float, default=None)
    ap.add_argument("--inner_solver", choices=("fista", "aipp"),
                    default=None,
                    help="AL subproblem solver: ADAP-FISTA (default) or "
                         "ADAP-AIPP (prox-point wrapper)")
    ap.add_argument("--run_tests", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs (default: the first GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.run_tests:
        return run_tests(device)
    if args.input is None:
        ap.error("an input file (-i) is required unless --run_tests")

    cfg = read_options_cfg(args.config) if args.config else {}
    overrides = {}
    if args.inner_solver is not None:
        overrides["inner_solver"] = args.inner_solver
    params, cfg_tau = params_from_cfg(cfg, **overrides)
    tau = args.trace_bound if args.trace_bound is not None else cfg_tau

    from .solver import hallar_solve

    prob = _load_problem(args.input, tau)
    res = hallar_solve(prob, params, verbose=True, device=device)
    print(f"status: {'optimal' if res.converged else 'maxiter'}  "
          f"pobj: {res.pobj:.8e}  pinf: {res.pinf:.3e}  "
          f"gap: {res.rel_gap:.3e}  rank: {res.final_rank}  "
          f"time: {res.solve_time:.2f}s")
    if args.output:
        with open(args.output, "w") as fh:
            json.dump({
                "pobj": res.pobj, "dval": res.dval, "pinf": res.pinf,
                "rel_gap": res.rel_gap, "iters": res.iters,
                "final_rank": res.final_rank,
                "solve_time": res.solve_time,
                "converged": res.converged,
                "fista_steps": res.fista_steps,
                "host_reads": res.host_reads,
                "graph_replays": res.graph_replays,
                "graph_runs": res.graph_runs,
                "device": str(device),
            }, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
