"""Theta's ALM / ADMM / CG counts under vertex relabelings.

A relabeling renames the graph's vertices (``testing.theta_sdpa(...,
relabel=k)``, k = 0 the identity): the same SDP, its sums taken in another
order.  The spread of the counts over relabelings is the yardstick for a
count that differs between two correct programs (the JAX package's and the
port's, or the port's on the host and on the card).  This script solves
``theta_sdpa(N, N // 4, N, relabel=k)`` with the CLI's parameters, on the
card (the replayed device loops) or with ``--device cpu`` (the host's line
search), and prints one JSON line a relabeling, then one line with each
count's [min, max].  ``tests/test_torch_theta_relabel.py`` prints the JAX
package's counts of the same instances.

    python -m ltr_lowrank_sdp_torch.scripts.theta_relabel [--n 300] \\
        [--relabel 0,1,2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

COUNTS = ("alm_outer", "alm_inner", "admm", "cg")


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


def spread(rows: list) -> dict:
    """Each count's [min, max] over the rows."""
    return {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
            for k in COUNTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--relabel", default="0-7")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("theta_relabel: no CUDA device is available",
                  file=sys.stderr)
            return 2
        from ..ops import kernels as K

        K.build_kernels()
    rows = []
    for k in parse_relabels(args.relabel):
        rows.append(port_counts(args.n, k, args.device))
        print(json.dumps({"device": args.device, **rows[-1]}), flush=True)
    print(json.dumps({"device": args.device, "n": args.n,
                      "spread": spread(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
