"""``hallar_solve`` of the port against the JAX package's on a 200-node
random MaxCut with trace bound tau = n (the diagonal constraints make tr X =
n, so the bound is active), the reference's Lanczos starts injected: six
outer iterations, the rank growing from 2 to 7 by escape steps.

Backtracking tests that flip through rounding (``test_torch_hallar_solve.py``)
make the two solves take other inner step counts (JAX 51,734, the port
57,935), so they end apart by more than rounding: pobj agrees to 1.0e-9
relative, dval to 2.2e-8 (its certificate reads the multiplier those steps
moved) and X = Y Y^T to 1.1e-3 of its largest entry, which is the
reference's own spread: perturbing its Y0 by 1e-13 relative moves its X by
1.07e-3 (by 1.2e-4 at 1e-15; ``reference_spread`` in
``test_torch_hallar_solve.py``).  Both certify the same gap to 1e-7.
"""

import numpy as np
import torch

from ltr_lowrank_sdp_torch.hallar import solver as TS
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem
from ltr_lowrank_sdp_tpu.hallar import solver as JS
from ltr_lowrank_sdp_tpu.testing import random_maxcut_problem as jax_maxcut

from test_torch_hallar_solve import jax_start, rel, x_err


def test_maxcut_200_trace_bound_matches_the_jax_solve():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JS.hallar_solve(
            JS.SpectraplexProblem.from_sdp_problem(jax_maxcut(200), 200.0),
            JS.HallarParams())
        got = TS.hallar_solve(
            TS.SpectraplexProblem.from_sdp_problem(
                random_maxcut_problem(200), 200.0),
            TS.HallarParams(), device="cpu",
            lanczos_start=jax_start("float64"))
    finally:
        torch.set_num_threads(n)
    assert (got.iters, got.final_rank, got.converged) == (6, 7, True)
    assert (ref.iters, ref.final_rank, ref.converged) == (6, 7, True)
    print(rel(got.pobj, ref.pobj), rel(got.dval, ref.dval), x_err(got, ref),
          got.fista_steps)
    assert rel(got.pobj, ref.pobj) <= 1e-8
    assert rel(got.dval, ref.dval) <= 1e-7
    assert abs(got.rel_gap - ref.rel_gap) <= 1e-7
    assert x_err(got, ref) <= 5e-3
    assert got.pinf <= 1e-5 and got.rel_gap <= 1e-5
