"""The scaling report's twin (``ltr_lowrank_sdp_torch/scripts/
scaling_report.py``) on gloo ranks on the CPU (one torch thread a rank)
against the JAX script's ``measure`` (``scripts/scaling_report.py:39-75``).

* ``measure``'s calls written out at n = 1,024 (it fixes n = 8,192), one
  device: the inner iterations of the ALM phase from the JAX package's
  starting factors.  The twin from the same factors, at world sizes 1
  (unsharded and sharded) and 2, gives exactly that count on every row: the
  JAX artifact's own claim (``scaling.json`` "note"), and the two packages
  count alike on MaxCut without a reopt round.
* ``main`` writes the JAX script's keys (``what``, ``note``, ``rows``,
  ``host_cpus``; per row ``devices``, ``inner_iters``, ``seconds``,
  ``alm_inner_iters_per_sec``, ``speedup_vs_1dev``); with no row measured it
  returns 1 and writes nothing; it refuses an NCCL world larger than the
  card count before it starts a rank.
"""

import json

import jax
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.config import SolverParams as JaxSolverParams
from ltr_lowrank_sdp_tpu.solver.alm import (make_alm_carry as jax_carry,
                                            make_outer_ctrl as jax_ctrl)
from ltr_lowrank_sdp_tpu.solver.common import init_factors as jax_init
from ltr_lowrank_sdp_tpu.solver.driver import Solver as JaxSolver
from ltr_lowrank_sdp_tpu.solver.rank import make_rank_state as jax_ranks
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_maxcut)
from ltr_lowrank_sdp_torch.scripts import scaling_report as SR

N = 1024
JAX_KEYS = {"what", "note", "rows", "host_cpus"}
JAX_ROW_KEYS = {"devices", "inner_iters", "seconds",
                "alm_inner_iters_per_sec", "speedup_vs_1dev"}


@pytest.fixture(scope="module")
def jax_measure():
    """``measure``'s calls at n = N: (inner iterations, the starting factors
    in the problem's own row order)."""
    prob = jax_maxcut(N, avg_degree=SR.JAX_DEGREE, seed=SR.JAX_SEED)
    params = JaxSolverParams(dtype="float64", disable_oracle=True,
                             fixed_rank=SR.JAX_RANK)
    sv = JaxSolver(prob, params)
    rs = jax_ranks(prob, params)
    R, rlp = jax_init(rs.ranks, prob.block_dims, prob.n_lp_cols,
                      jax.random.PRNGKey(params.seed), sv.dtype)
    R0 = [ops.permute_rows_out(np.asarray(r)) for ops, r in zip(sv.cones, R)]
    R = sv._place_factors(R)
    alm, _ = sv.phases(rs.ranks)
    carry = jax_carry(R, rlp, prob.m, alm.n_elems,
                      1.0 / np.sqrt(sum(prob.block_dims)), params, sv.dtype)
    carry = alm.prepare(carry)
    ctrl = jax_ctrl(params, 1, 1, params.alm_rho_factor, dtype=sv.dtype)
    step = alm._phase_step_j("main", False, True, 1e9,
                             int(params.max_alm_iter))
    c, ct, n, buf = step(carry, ctrl)
    jax.block_until_ready(buf)
    c, ct = carry, ctrl
    for _ in range(8):
        c, ct, n, buf = step(c, ct)
        jax.block_until_ready(buf)
        if int(jax.device_get(ct.code)) != 0:
            break
    return int(jax.device_get(ct.inner_total)), R0


@pytest.fixture(scope="module")
def twin(jax_measure):
    """The twin's rows at world sizes 1 and 2, each from JAX's factors."""
    R0 = [np.asarray(f, np.float64) for f in jax_measure[1]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SR, "starting_factors", lambda prob, params: R0)
        return SR.report((1, 2), SR.jax_problem(N), SR.jax_params(),
                         "constr", "cpu")


def test_inner_iters_equal_at_world_sizes_1_and_2(twin):
    rows = twin["rows"]
    assert [(r["devices"], r["mode"]) for r in rows] == [
        (1, "unsharded"), (1, "sharded"), (2, "sharded")]
    assert len({r["inner_iters"] for r in rows}) == 1
    assert all(r["dispatches"] == 1 for r in rows)
    assert rows[0]["collectives"] == 0
    assert all(r["collectives"] > 0 and r["ms_per_collective"] > 0
               for r in rows[1:])
    assert rows[1]["speedup_vs_1dev"] == 1.0
    assert twin["backend"] == "gloo" and twin["cards"] is None


def test_inner_iters_equal_the_jax_measure(twin, jax_measure):
    assert jax_measure[0] > 0
    assert [r["inner_iters"] for r in twin["rows"]] == [jax_measure[0]] * 3


def test_main_writes_the_jax_keys(tmp_path, monkeypatch):
    full = SR.jax_problem
    monkeypatch.setattr(SR, "jax_problem", lambda n=N: full(N))
    out = tmp_path / "scaling.json"
    assert SR.main(["--device", "cpu", "--devices", "1",
                    "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert JAX_KEYS <= set(payload)
    assert payload["problem"]["n"] == N and payload["axis"] == "constr"
    assert [r["mode"] for r in payload["rows"]] == ["unsharded", "sharded"]
    for row in payload["rows"]:
        assert JAX_ROW_KEYS <= set(row)
        assert row["alm_inner_iters_per_sec"] == pytest.approx(
            row["inner_iters"] / row["seconds"])


def test_main_writes_nothing_without_a_row(tmp_path, monkeypatch, capsys):
    def lost(*args, **kwargs):
        raise RuntimeError("a rank failed")

    monkeypatch.setattr(SR, "spawn", lost)
    out = tmp_path / "scaling.json"
    assert SR.main(["--device", "cpu", "--devices", "2",
                    "--out", str(out)]) == 1
    assert not out.exists()
    assert "no scaling rows measured" in capsys.readouterr().err


def test_main_refuses_more_nccl_ranks_than_cards(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    out = tmp_path / "scaling.json"
    assert SR.main(["--devices", "1,2,4", "--out", str(out)]) == 2
    assert not out.exists()
    assert ("4 NCCL ranks need 4 cards, this host has 2"
            in capsys.readouterr().err)
