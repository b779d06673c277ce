"""Theta's ALM inner count against the JAX package's own spread.

The port's theta solve takes another number of L-BFGS steps than the JAX
package's (the closed-form quartic root is ill-conditioned on theta's
quartics, and two correct programs round it differently).  A relabeling of
the graph's vertices (``testing.theta_sdpa(..., relabel=k)``) is the same
SDP summed in another order: the JAX package's counts over relabelings are
the spread its own rounding gives.  ``theta_counts.json`` holds 32
relabelings solved by the JAX package, the port on the card and the port on
the CPU; ``compare`` holds the port's counts to the JAX package's as
distributions (a test fixed before the counts were measured), and its
verdict is the one ``ROADMAP.md`` records.

    python tests/test_torch_theta_relabel.py N K1 K2 ...   # JAX's rows, one JSON line each
"""

import json
import os
import pathlib
import re
import sys
import tempfile
import time

import numpy as np
import pytest

from ltr_lowrank_sdp_torch.scripts.theta_relabel import (PROGRAMS, compare,
                                                        load_counts, row,
                                                        verdict)
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
        print(json.dumps(row("jax-cpu", jax_counts(n_arg, int(k)), "cpu")),
              flush=True)


# --------------------------------------------------------------------------- #
# the distributions over 32 relabelings (theta_counts.json)
# --------------------------------------------------------------------------- #

ROADMAP = pathlib.Path(__file__).resolve().parent.parent / "ROADMAP.md"


def _rows(program, inner, outer=19, admm=453, cg=1343):
    return [{"k": k, "program": program, "outer": o, "inner": i, "admm": admm,
             "cg": cg} for k, (i, o) in enumerate(zip(inner, outer))]


def test_counts_file_holds_every_relabeling_three_ways():
    rows = load_counts()
    assert set(rows) == set(PROGRAMS)
    for program, rs in rows.items():
        assert [r["k"] for r in rs] == list(range(32)), program
        for r in rs:
            assert r["status"] == "primal_dual_optimal", (program, r["k"])
            assert r["outer"] in (17, 18, 19) and r["final_ranks"] == [141]
            assert set(r) >= {"k", "program", "outer", "inner", "admm", "cg",
                              "status", "pobj", "device"}
    assert all("H100" in r["device"] and " W" in r["device"]
               for r in rows["port-card"])
    assert all(r["device"].startswith("cpu, 1 torch thread")
               for r in rows["port-cpu"])
    # k = 0, solved again with the same code: the JAX package's count and
    # the card's replayed loops' count reproduce the rows
    assert rows["jax-cpu"][0]["inner"] == 17926
    assert rows["port-card"][0]["inner"] == 18558


def test_compare_gives_the_verdict_the_roadmap_records():
    got = verdict()
    text = ROADMAP.read_text()
    for program in ("port-card", "port-cpu"):
        m = re.search(rf"`compare` verdict,\s+{program}:\s+(pass|fail)",
                      text)
        assert m, program
        assert got[program]["ok"] == (m.group(1) == "pass"), got[program]
        assert got[program]["n"] == [32, 32]


@pytest.mark.parametrize("shift,low,ok", [
    (0, 3, True),          # the same distribution
    (60, 3, True),         # a shift well inside the spread
    (2000, 3, False),      # a shift past it: the inner tests fail
    (0, 20, False),        # the low mode far more frequent: Fisher fails
])
def test_compare_decides_on_distributions(shift, low, ok):
    rng = np.random.default_rng(7)
    base = 18700 + rng.normal(0, 400, 32).round()
    outer = [17] * 3 + [19] * 29
    jax_rows = _rows("jax-cpu", base, outer)
    port = base[::-1] + shift
    port_outer = [17] * low + [19] * (32 - low)
    got = compare(jax_rows, _rows("port-card", port, port_outer))
    assert got["ok"] == ok, got
    assert set(got["p"]) == {"low_mode_share", "inner_high_mode_mwu",
                             "inner_high_mode_ks", "admm_mwu", "cg_mwu"}
