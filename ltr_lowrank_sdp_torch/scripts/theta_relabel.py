"""Theta's ALM / ADMM / CG counts under vertex relabelings.

A relabeling renames the graph's vertices (``testing.theta_sdpa(...,
relabel=k)``, k = 0 the identity): the same SDP, its sums taken in another
order.  The spread of the counts over relabelings is the yardstick for a
count that differs between two correct programs (the JAX package's and the
port's, or the port's on the host and on the card).  This script solves
``theta_sdpa(N, N // 4, N, relabel=k)`` with the CLI's parameters, on the
card (the replayed device loops) or with ``--device cpu`` (the host's line
search, on one torch thread), and prints one JSON line a relabeling (the row
format of ``theta_counts.json``), then one line with each count's [min,
max].
``tests/test_torch_theta_relabel.py`` prints the JAX package's rows of the
same instances.

``theta_counts.json`` holds 32 relabelings solved three ways (the JAX
package on the CPU in float64, the port on the card, the port on the CPU
with one torch thread); :func:`compare` holds the port's counts to the JAX
package's as two distributions, by a test fixed before they were measured.

    python -m ltr_lowrank_sdp_torch.scripts.theta_relabel [--n 300] \\
        [--relabel 0,1,2] [--device cpu] > rows.log
    python -m ltr_lowrank_sdp_torch.scripts.theta_relabel --merge \\
        jax.log card.log cpu.log
    python -m ltr_lowrank_sdp_torch.scripts.theta_relabel --compare \\
        [theta_counts.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

COUNTS = ("alm_outer", "alm_inner", "admm", "cg")
COUNTS_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "theta_counts.json")
PROGRAMS = ("jax-cpu", "port-card", "port-cpu")
# the verdict's level: every two-sided p-value must reach it
ALPHA = 0.05
# the low ALM outer mode (17 outer iterations near 13.5k inner)
LOW_OUTER = 17


def parse_relabels(spec: str) -> list:
    """``"0-3,7"`` -> [0, 1, 2, 3, 7]."""
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def port_counts(n: int, relabel: int, device: str) -> dict:
    """The port's solve of ``theta_sdpa(n, n // 4, n, relabel)`` with the
    CLI's parameters: status, counts, final ranks, pobj, seconds."""
    from .. import cli
    from ..problem import load_problem
    from ..solver.driver import Solver
    from ..testing import theta_sdpa, write_sdpa

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"theta{n}_{relabel}.dat-s")
        write_sdpa(path, theta_sdpa(n, n // 4, n, relabel=relabel))
        prob = load_problem(path)
        params = cli.params_from_args(
            cli.build_arg_parser().parse_args([path]))
    t = time.perf_counter()
    res = Solver(prob, params, device=device).solve()
    return {"relabel": relabel, "status": res.status.value,
            "alm_outer": res.alm_outer_iters,
            "alm_inner": res.alm_inner_iters, "admm": res.admm_iters,
            "cg": res.cg_iters, "final_ranks": list(res.final_ranks),
            "pobj": res.pobj, "seconds": round(time.perf_counter() - t, 1)}


def row(program: str, counts: dict, device: str) -> dict:
    """One row of ``theta_counts.json`` from a solve's counts."""
    return {"k": counts["relabel"], "program": program,
            "outer": counts["alm_outer"], "inner": counts["alm_inner"],
            "admm": counts["admm"], "cg": counts["cg"],
            "status": counts["status"], "pobj": counts["pobj"],
            "final_ranks": counts["final_ranks"],
            "seconds": counts["seconds"], "device": device}


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), or "unknown"."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def device_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    CPU's torch thread count and model."""
    if device == "cpu":
        import torch

        return f"cpu, {torch.get_num_threads()} torch thread(s), {cpu_model()}"
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load_counts(path: str = COUNTS_JSON) -> dict:
    """``theta_counts.json`` -> {program: rows sorted by k}."""
    with open(path) as f:
        rows = json.load(f)["rows"]
    return {p: sorted((r for r in rows if r["program"] == p),
                      key=lambda r: r["k"]) for p in PROGRAMS}


def compare(jax_rows: list, port_rows: list, alpha: float = ALPHA) -> dict:
    """The port's counts against the JAX package's, as distributions over
    relabelings (the test fixed before the counts were measured):

    * the share of solves in the low outer mode: Fisher's exact test;
    * the ALM inner counts of the solves in the high (19 outer) mode: the
      Mann-Whitney U and two-sample Kolmogorov-Smirnov tests;
    * the ADMM and CG counts over all relabelings: Mann-Whitney U.

    Every test two-sided; ``ok`` when every p-value is at least ``alpha``.
    """
    from scipy import stats

    def low(rows):
        return sum(r["outer"] <= LOW_OUTER for r in rows)

    def high_inner(rows):
        return [r["inner"] for r in rows if r["outer"] > LOW_OUTER]

    lj, lp = low(jax_rows), low(port_rows)
    p = {"low_mode_share": float(stats.fisher_exact(
        [[lj, len(jax_rows) - lj], [lp, len(port_rows) - lp]],
        alternative="two-sided")[1])}
    hj, hp = high_inner(jax_rows), high_inner(port_rows)
    p["inner_high_mode_mwu"] = float(stats.mannwhitneyu(
        hj, hp, alternative="two-sided").pvalue)
    p["inner_high_mode_ks"] = float(stats.ks_2samp(
        hj, hp, alternative="two-sided").pvalue)
    for key in ("admm", "cg"):
        p[f"{key}_mwu"] = float(stats.mannwhitneyu(
            [r[key] for r in jax_rows], [r[key] for r in port_rows],
            alternative="two-sided").pvalue)
    return {"ok": all(v >= alpha for v in p.values()), "p": p,
            "n": [len(jax_rows), len(port_rows)], "low_mode": [lj, lp],
            "high_mode_inner_median": [float(sorted(hj)[len(hj) // 2]),
                                       float(sorted(hp)[len(hp) // 2])]}


def merge(paths: list, out: str = COUNTS_JSON, n: int = 300) -> dict:
    """Write the rows printed by this script and by the JAX package's
    ``tests/test_torch_theta_relabel.py`` as ``theta_counts.json``: one row
    a (program, k), the first one read; other lines are skipped."""
    rows = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.startswith('{"k"'):
                    continue
                r = json.loads(line)
                rows.setdefault((PROGRAMS.index(r["program"]), r["k"]), r)
    doc = {"instance": f"testing.theta_sdpa({n}, {n // 4}, {n}, relabel=k)",
           "params": "the CLI's defaults", "programs": list(PROGRAMS),
           "rows": [rows[key] for key in sorted(rows)]}
    head = json.dumps({k: v for k, v in doc.items() if k != "rows"})
    with open(out, "w") as f:       # one row a line
        f.write(head[:-1] + ', "rows": [\n' + ",\n".join(
            json.dumps(r) for r in doc["rows"]) + "\n]}\n")
    return doc


def verdict(path: str = COUNTS_JSON) -> dict:
    """:func:`compare` of the card's and the CPU port's rows against the
    JAX package's."""
    rows = load_counts(path)
    return {p: compare(rows["jax-cpu"], rows[p])
            for p in ("port-card", "port-cpu")}


def spread(rows: list) -> dict:
    """Each count's [min, max] over the rows."""
    return {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
            for k in COUNTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--relabel", default="0-7")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", nargs="?", const=COUNTS_JSON, default=None,
                    help="print compare()'s verdict on a counts file")
    ap.add_argument("--merge", nargs="+", default=None, metavar="LOG",
                    help="write the rows these outputs printed as "
                         "theta_counts.json")
    args = ap.parse_args(argv)
    if args.merge:
        doc = merge(args.merge, n=args.n)
        print(f"{len(doc['rows'])} rows -> {COUNTS_JSON}")
        return 0
    if args.compare:
        print(json.dumps(verdict(args.compare), indent=1))
        return 0
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            print("theta_relabel: no CUDA device is available",
                  file=sys.stderr)
            return 2
        from ..ops import kernels as K

        K.build_kernels()
    program = "port-cpu" if args.device == "cpu" else "port-card"
    name = device_name(args.device)
    rows = []
    for k in parse_relabels(args.relabel):
        rows.append(port_counts(args.n, k, args.device))
        print(json.dumps(row(program, rows[-1], name)), flush=True)
    print(json.dumps({"device": args.device, "n": args.n,
                      "spread": spread(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
