"""Dataset harvesting: sweep instances, solve with trajectory logging, and
process graphs — the reference's ``dataset/run_lorads.sh`` +
``dataset/run_parser.sh`` combined into one Python driver.

The port's twin of the repository's ``scripts/harvest.py``, with the same
flags plus ``--device`` / ``--cpu``.  For every ``*.dat-s`` under
--instances it
1. solves with per-family parameter heuristics (name/size regex rules of
   ``run_lorads.sh:26-77``), writing ``sol_json/<name>.json`` (the oracle
   rank trajectory = training labels) and ``logs/<name>.log``;
2. processes the instance into graph features at ``proc/<name>.npz`` (on
   the host).

Skips existing outputs unless ``--overwrite``; per-instance timeouts guard
runaway solves, and an instance that fails prints ``FAILED`` and the sweep
goes on, as the reference's batch does.  Each instance ends with one line of
its parse, solve and processing seconds.  It solves on ``cuda:0`` unless
``--device cpu`` (or ``--cpu``) is given; without a GPU it stops with an
error.

    python -m ltr_lowrank_sdp_torch.scripts.harvest --instances insts \\
        --root dataset [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import time
import traceback
from typing import List

from ..config import SolverParams


def family_params(name: str, n: int, timeout: float) -> SolverParams:
    """Per-family solver presets (``dataset/run_lorads.sh:26-77``)."""
    kw = dict(phase1_tol=1e-3, heuristic_factor=1.0, times_log_rank=2.0,
              rho_max=5000.0, time_sec_limit=timeout)
    maxcut_pats = (r"^[Gg][0-9]", r"^maxcut", r"^mcp", r"^p2p", r"^delaunay",
                   r"^rgg", r"^vsp", r"^cs[0-9]", r"^cit", r"^fe_",
                   r"^amazon", r"[0-9]+a$")
    if any(re.search(p, name) for p in maxcut_pats):
        if n >= 40000:
            kw.update(phase1_tol=1e1, heuristic_factor=100.0)
        else:
            kw.update(phase1_tol=1e-2, heuristic_factor=10.0)
    elif re.match(r"^[Mm][Cc]_", name):
        mc = re.search(r"(?:MC_|mc_)([0-9]+)", name)
        if mc:
            mc_n = int(mc.group(1))
            if mc_n >= 10000:
                kw.update(heuristic_factor=2.5, times_log_rank=1.0)
            elif mc_n >= 1000:
                kw.update(heuristic_factor=5.0)
    elif re.search(r"_mb$", name) or re.search(r"mc$", name):
        kw.update(phase1_tol=1e-2, heuristic_factor=10.0)
    return SolverParams(**kw)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="harvest solver trajectories")
    ap.add_argument("--instances", default="dataset/instances")
    ap.add_argument("--root", default="dataset")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--parse-timeout", type=float, default=900.0)
    ap.add_argument("--skip-solve", action="store_true")
    ap.add_argument("--skip-parse", action="store_true")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (the same as --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    return ap


def harvest(args, dev) -> List[dict]:
    """Solve and process every instance under ``args.instances`` on
    ``dev``; one dict a file: its name, the solve's status (None when not
    solved) and the parse, solve and processing seconds (None when not
    run)."""
    from ..data.processor import process_sdpa_to_graph
    from ..problem import load_problem
    from ..solver.driver import solve
    from ..solver.logging import TrajectoryLogger

    for sub in ("sol_json", "logs", "proc"):
        os.makedirs(os.path.join(args.root, sub), exist_ok=True)

    files = sorted(glob.glob(os.path.join(args.instances, "**", "*.dat-s"),
                             recursive=True))
    print(f"{len(files)} instances")
    done = []
    for path in files:
        name = os.path.basename(path).replace(".dat-s", "")
        json_out = os.path.join(args.root, "sol_json", f"{name}.json")
        log_out = os.path.join(args.root, "logs", f"{name}.log")
        proc_out = os.path.join(args.root, "proc", f"{name}.npz")
        row = {"name": name, "status": None, "parse_s": None,
               "solve_s": None, "process_s": None}

        if not args.skip_solve and (args.overwrite
                                    or not os.path.exists(json_out)):
            try:
                t0 = time.time()
                prob = load_problem(path)
                row["parse_s"] = time.time() - t0
                n = max(prob.block_dims) if prob.block_dims else 0
                params = family_params(name, n, args.timeout)
                logger = TrajectoryLogger(
                    params, problem_name=name, file_path=path,
                    log_file=log_out, verbose=False)
                t0 = time.time()
                res = solve(prob, params, logger=logger, json_path=json_out,
                            device=dev)
                row["solve_s"] = time.time() - t0
                row["status"] = res.status.value
                print(f"[solve] {name}: {res.status.value} "
                      f"{row['solve_s']:.1f}s gap {res.gap:.1e}")
            except Exception:
                print(f"[solve] {name}: FAILED")
                traceback.print_exc()

        if not args.skip_parse and (args.overwrite
                                    or not os.path.exists(proc_out)):
            try:
                t0 = time.time()
                process_sdpa_to_graph(path, proc_out)
                row["process_s"] = time.time() - t0
                print(f"[parse] {name}: {row['process_s']:.1f}s")
            except Exception:
                print(f"[parse] {name}: FAILED")
                traceback.print_exc()

        print(f"[harvest] {name}: " + ", ".join(
            f"{k[:-2]} {'-' if row[k] is None else f'{row[k]:.3f}'} s"
            for k in ("parse_s", "solve_s", "process_s")), flush=True)
        done.append(row)
    return done


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from .. import resolve_device

    harvest(args, resolve_device("cpu" if args.cpu else args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
