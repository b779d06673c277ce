"""Benchmark harness of the PyTorch port: default rank heuristics vs
predicted rank schedules.

    python -m ltr_lowrank_sdp_torch.benchmark --checkpoint runs/r5_theta \\
        --instances benchmark/instances --subtypes hansmittel --output-dir out
    python -m ltr_lowrank_sdp_torch.benchmark ... --device cpu

The twin of the repository's root ``benchmark.py``: for each instance of
each subtype it
(1) predicts a rank schedule with the GNN (if a checkpoint is given), from
    ``<root>/proc/<name>.npz`` when that exists and from the processor
    otherwise,
(2) writes ``<name>_r_sched.json`` ({"rank_schedule": [...],
    "schedule_length": N}),
(3) solves twice with the port's solver -- default dynamic-rank heuristics vs
    the injected schedule (``--rankSchedule`` semantics with nearStallFactor
    0.7 and the oracle off) -- with the per-family solver presets of
    ``get_lorads_params`` (``benchmark.py:136-206``),
(4) reports speedup = t_default / t_sched and obj_rel_diff, a results table
    and ``results.json``.

Pass ``--lorads-binary`` to also run an external LoRADS CPU binary for
cross-solver objective validation.  Everything runs on ``cuda:0`` unless
``--device cpu`` is given; without a GPU it stops with an error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time

import numpy as np

from . import resolve_device

SUBTYPES = ["gset", "hansmittel", "matcomp", "maxcut", "sdplib"]
DEFAULT_TIMEOUT = 300.0


def get_solver_params(subtype: str, n: int):
    """Per-family presets (reference ``benchmark.py:136-206`` and the
    result-table notes in ``lorads/README.md:166,197,228``)."""
    from .config import SolverParams

    kw = dict(time_sec_limit=DEFAULT_TIMEOUT)
    if subtype in ("gset", "maxcut"):
        if n >= 40000:
            kw.update(phase1_tol=1e1, heuristic_factor=100.0)
        else:
            kw.update(phase1_tol=1e-2, heuristic_factor=10.0)
    elif subtype == "matcomp":
        kw.update(heuristic_factor=10.0)
    elif subtype == "hansmittel":
        kw.update(phase1_tol=1e-2)
    return SolverParams(**kw)


def predict_schedule(ckpt, dat_s_path, root, device=None):
    from .data.processor import process_sdpa_to_graph
    from .models.checkpoint import load_model, predict_schedule_for_graph

    model, _ = load_model(ckpt, device=device)
    name = os.path.basename(dat_s_path).replace(".dat-s", "")
    cached = os.path.join(root, "proc", name + ".npz")
    if os.path.exists(cached):
        from .data.loader import _load_graph_file

        graph = _load_graph_file(cached)
    else:
        graph = process_sdpa_to_graph(dat_s_path, None)
    return predict_schedule_for_graph(model, graph)


def run_our_solver(dat_s_path, params, json_out, device=None):
    from .problem import load_problem
    from .solver.driver import solve

    prob = load_problem(dat_s_path)
    t0 = time.time()
    res = solve(prob, params, json_path=json_out, device=device)
    return {
        "solve_time_sec": time.time() - t0,
        "primal_obj": res.pobj,
        "gap": res.gap,
        "pinf_l1": res.pinf_l1,
        "dinf_l1": res.dinf_l1,
        "status": res.status.value,
    }


def run_lorads_binary(binary, dat_s_path, json_out, extra_args=(),
                      timeout=DEFAULT_TIMEOUT):
    """Optional external LoRADS run for cross-solver validation."""
    cmd = [binary, dat_s_path, "--jsonfile", json_out, *extra_args]
    try:
        subprocess.run(cmd, capture_output=True, timeout=timeout + 60)
    except subprocess.TimeoutExpired:
        return None
    if not os.path.exists(json_out):
        return None
    with open(json_out) as f:
        payload = json.load(f)
    met = payload.get("metrics", {})
    return {
        "solve_time_sec": met.get("solve_time_sec"),
        "primal_obj": met.get("primal_obj"),
    }


def list_instances(instances_dir, subtype):
    pats = [os.path.join(instances_dir, subtype, "*.dat-s"),
            os.path.join(instances_dir, "*.dat-s")]
    out = []
    for p in pats:
        out.extend(sorted(glob.glob(p)))
    return sorted(set(out))


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="schedule-vs-default benchmark")
    ap.add_argument("--checkpoint", default=None,
                    help="rank predictor checkpoint (omit -> fixedRank mode)")
    ap.add_argument("--instances", default="benchmark/instances")
    ap.add_argument("--root", default="dataset")
    ap.add_argument("--subtypes", nargs="*", default=SUBTYPES)
    ap.add_argument("--output-dir", default="benchmark/results")
    ap.add_argument("--lorads-binary", default=None)
    ap.add_argument("--fixed-rank", type=int, default=None,
                    help="without a checkpoint: compare vs this fixed rank")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the predictor and the solves run (default: "
                         "the first GPU)")
    ap.add_argument("--merge", action="store_true",
                    help="update rows in an existing results.json instead "
                         "of overwriting it")
    ap.add_argument("--skip", nargs="*", default=None,
                    help="instance names to skip this run")
    ap.add_argument("--only", nargs="*", default=None,
                    help="restrict to these instance names")
    return ap


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    # a missing GPU is reported before anything is read
    device = resolve_device(None if args.device == "cuda" else "cpu")

    os.makedirs(args.output_dir, exist_ok=True)
    results = {}
    res_path = os.path.join(args.output_dir, "results.json")
    if args.merge and os.path.exists(res_path):
        # re-measurement runs update rows in place instead of discarding
        # instances this invocation does not cover
        with open(res_path) as f:
            results = json.load(f)
    rows = []
    seen = set()
    for subtype in args.subtypes:
        for inst in list_instances(args.instances, subtype):
            # dir-level instances match every subtype's fallback glob; run
            # each file once, under the first subtype that claims it
            if inst in seen:
                continue
            seen.add(inst)
            name = os.path.basename(inst).replace(".dat-s", "")
            if args.skip and name in args.skip:
                continue
            if args.only and name not in args.only:
                continue
            from .io.sdpa import read_sdpa

            hdr = read_sdpa(inst)
            n = max(hdr.block_dims) if hdr.block_dims else 0
            params = get_solver_params(subtype, n)

            schedule = None
            if args.checkpoint:
                schedule, L = predict_schedule(args.checkpoint, inst,
                                               args.root, device)
                sched_path = os.path.join(args.output_dir,
                                          f"{name}_r_sched.json")
                with open(sched_path, "w") as f:
                    json.dump({"rank_schedule": schedule,
                               "schedule_length": L}, f)

            default = run_our_solver(
                inst, params,
                os.path.join(args.output_dir, f"{name}_default.json"),
                device)

            if schedule is not None:
                p_sched = params.replace(
                    rank_schedule=schedule, near_stall_factor=0.7,
                    disable_oracle=True)
            elif args.fixed_rank:
                p_sched = params.replace(fixed_rank=args.fixed_rank)
            else:
                p_sched = None
            sched_res = None
            if p_sched is not None:
                sched_res = run_our_solver(
                    inst, p_sched,
                    os.path.join(args.output_dir, f"{name}_sched.json"),
                    device)

            row = {
                "name": name, "subtype": subtype, "n": n,
                "default": default, "schedule": sched_res,
            }
            if sched_res:
                row["speedup"] = (default["solve_time_sec"]
                                  / max(sched_res["solve_time_sec"], 1e-9))
                row["obj_rel_diff"] = abs(
                    default["primal_obj"] - sched_res["primal_obj"]
                ) / (1 + abs(default["primal_obj"]))
            if args.lorads_binary:
                ext = run_lorads_binary(
                    args.lorads_binary, inst,
                    os.path.join(args.output_dir, f"{name}_lorads.json"),
                    timeout=args.timeout)
                if ext:
                    row["lorads"] = ext
                    row["vs_lorads_speedup"] = (
                        (ext["solve_time_sec"] or 0)
                        / max(default["solve_time_sec"], 1e-9))
            results[name] = row
            rows.append(row)
            sp = row.get("speedup")
            print(f"{name:>24} n={n:<8} default "
                  f"{default['solve_time_sec']:7.2f}s obj "
                  f"{default['primal_obj']:.6e}"
                  + (f"  sched {sched_res['solve_time_sec']:7.2f}s "
                     f"speedup {sp:.2f}x" if sched_res else ""))

    with open(res_path, "w") as f:
        json.dump(results, f, indent=2)

    speedups = [r["speedup"] for r in rows if "speedup" in r]
    if speedups:
        print(f"\ngeometric-mean speedup: "
              f"{float(np.exp(np.mean(np.log(speedups)))):.2f}x "
              f"over {len(speedups)} instances")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
