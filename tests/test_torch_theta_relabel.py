"""Theta's ALM inner count against the JAX package's own spread.

The port's theta solve takes another number of L-BFGS steps than the JAX
package's (the closed-form quartic root is ill-conditioned on theta's
quartics, and two correct programs round it differently).  A relabeling of
the graph's vertices (``testing.theta_sdpa(..., relabel=k)``) is the same
SDP summed in another order: the JAX package's counts over relabelings are
the spread its own rounding gives, and the port's count is held to lie
within it.

    python tests/test_torch_theta_relabel.py N K1 K2 ...   # JAX's counts, one JSON line each
"""

import json
import os
import sys
import tempfile
import time

import pytest

from ltr_lowrank_sdp_torch.scripts.theta_relabel import port_counts, spread
from ltr_lowrank_sdp_torch.testing import theta_sdpa, write_sdpa


def jax_counts(n: int, relabel: int) -> dict:
    """The JAX package's solve of ``theta_sdpa(n, n // 4, n, relabel)`` on
    the CPU in float64 with its default parameters (the CLI's)."""
    from ltr_lowrank_sdp_tpu.problem import load_problem as jax_load
    from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"theta{n}_{relabel}.dat-s")
        write_sdpa(path, theta_sdpa(n, n // 4, n, relabel=relabel))
        t = time.perf_counter()
        res = JaxSolver(jax_load(path)).solve()
    return {"relabel": relabel, "status": res.status.value,
            "alm_outer": res.alm_outer_iters,
            "alm_inner": res.alm_inner_iters, "admm": res.admm_iters,
            "cg": res.cg_iters, "final_ranks": list(res.final_ranks),
            "pobj": float(res.pobj),
            "seconds": round(time.perf_counter() - t, 1)}


if __name__ == "__main__":
    n_arg = int(sys.argv[1])
    for k in sys.argv[2:]:
        print(json.dumps({"package": "jax", "n": n_arg,
                          **jax_counts(n_arg, int(k))}), flush=True)
