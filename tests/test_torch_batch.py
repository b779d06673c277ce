"""Batched MaxCut ALM steps of the port (``parallel/batch.py``) against the
JAX package's ``batched_alm_steps``.

The inputs are ``tests/test_sharding.py``'s (B = 8, n = 24, r = 4, 60
objective entries per instance with duplicate (row, col) pairs, 25 steps);
the port runs them on two gloo ranks (one spawn for the module, one torch
thread per rank) at batch axes 1 and 2, and R, dual and pinf must agree
with JAX's to 1e-10.  The device line search is held to the host one per
instance, and the block-diagonal CSR that carries C·Y (K1) must keep
duplicate entries, as the scatter-add it replaces adds each one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltr_lowrank_sdp_tpu.parallel.batch import (
    BatchedMaxCutProblem as JaxBatchedMaxCutProblem)
from ltr_lowrank_sdp_tpu.parallel.batch import (
    batched_alm_steps as jax_batched_alm_steps)
from ltr_lowrank_sdp_tpu.parallel.batch import (
    batched_from_problems as jax_batched_from_problems)
from ltr_lowrank_sdp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ltr_lowrank_sdp_tpu.testing import (
    random_maxcut_problem as jax_random_maxcut_problem)
from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.ops.cubic import quartic_argmin, quartic_argmin_t
from ltr_lowrank_sdp_torch.parallel.batch import (BatchedMaxCutProblem,
                                                  batched_alm_steps,
                                                  batched_from_problems)
from ltr_lowrank_sdp_torch.parallel.launch import spawn
from ltr_lowrank_sdp_torch.parallel.mesh import make_mesh
from ltr_lowrank_sdp_torch.testing import random_maxcut_problem

B, N, RANK, NNZ, STEPS = 8, 24, 4, 60, 25
BATCH_AXES = (1, 2)


def _inputs():
    """``tests/test_sharding.py``'s draws."""
    rng = np.random.default_rng(1)
    rows = rng.integers(0, N, size=(B, NNZ)).astype(np.int32)
    cols = np.maximum(rows, rng.integers(0, N, size=(B, NNZ)).astype(np.int32))
    vals = rng.normal(size=(B, NNZ))
    R = rng.normal(size=(B, N, RANK))
    return rows, cols, vals, R


def _rank_steps():
    rows, cols, vals, R = _inputs()
    prob = BatchedMaxCutProblem(
        c_rows=torch.tensor(rows), c_cols=torch.tensor(cols),
        c_vals=torch.tensor(vals), b=torch.ones((B, N), dtype=torch.float64),
        n=N)
    out = {}
    for batch in BATCH_AXES:
        mesh = make_mesh(batch=batch, device="cpu")
        got = batched_alm_steps(mesh, prob, torch.tensor(R),
                                torch.zeros((B, N), dtype=torch.float64), 1.0,
                                num_steps=STEPS)
        out[batch] = [t.numpy() for t in got]
    return out


@pytest.fixture(scope="module")
def jax_result():
    rows, cols, vals, R = _inputs()
    prob = JaxBatchedMaxCutProblem(
        c_rows=jnp.asarray(rows), c_cols=jnp.asarray(cols),
        c_vals=jnp.asarray(vals), b=jnp.ones((B, N)), n=N)
    mesh = jax_make_mesh(len(jax.devices()), batch=len(jax.devices()))
    out = jax_batched_alm_steps(mesh, prob, jnp.asarray(R), jnp.zeros((B, N)),
                                1.0, num_steps=STEPS)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def port_result():
    return spawn(_rank_steps, 2)


@pytest.mark.parametrize("batch", BATCH_AXES)
def test_batched_alm_steps_match_jax(port_result, jax_result, batch):
    for rank_out in port_result:
        for name, got, want in zip(("R", "dual", "pinf"), rank_out[batch],
                                   jax_result):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10,
                                       err_msg=name)
    # the spec of tests/test_sharding.py: every instance's infeasibility
    # drops, the worst by half
    _, _, _, R = _inputs()
    pinf0 = np.linalg.norm(1.0 - np.sum(R * R, axis=2), axis=1) / (1.0 + N)
    pinf = port_result[0][batch][2]
    assert np.all(pinf < pinf0) and pinf.max() < 0.5 * pinf0.max()


def test_batched_alm_steps_same_bits_on_every_rank_and_axis(port_result):
    ref = port_result[0][BATCH_AXES[0]]
    for rank_out in port_result:
        for batch in BATCH_AXES:
            for got, want in zip(rank_out[batch], ref):
                np.testing.assert_array_equal(got, want)


def test_batch_axis_must_divide_the_instances():
    from ltr_lowrank_sdp_torch.parallel.mesh import Mesh

    mesh = Mesh(shape={"batch": 3, "constr": 1},
                axis_names=("batch", "constr"), rank=0, coords=(0, 0),
                device=torch.device("cpu"), groups={})
    rows, cols, vals, R = _inputs()
    prob = BatchedMaxCutProblem(torch.tensor(rows), torch.tensor(cols),
                                torch.tensor(vals), torch.ones((B, N)), N)
    with pytest.raises(ValueError, match="does not divide"):
        batched_alm_steps(mesh, prob, torch.tensor(R), torch.zeros((B, N)),
                          1.0)


def test_batched_from_problems_matches_jax():
    sizes = ((30, 4, 0), (24, 3, 1), (30, 5, 2))
    got = batched_from_problems([random_maxcut_problem(*s) for s in sizes])
    want = jax_batched_from_problems(
        [jax_random_maxcut_problem(*s) for s in sizes])
    assert got.n == want.n == 30
    for name in ("c_rows", "c_cols", "c_vals", "b"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_device_line_search_matches_host_per_instance():
    rng = np.random.default_rng(4)
    coeffs = rng.normal(size=(400, 4)) * 10.0 ** rng.integers(-3, 4, (400, 4))
    coeffs[:20, 0] = 0.0                # no quartic term
    coeffs[20:40, :2] = 0.0             # quadratic
    coeffs[40:50] = 0.0                 # flat
    coeffs[50:60, 0] = np.abs(coeffs[50:60, 0])
    tau, num = quartic_argmin_t(*torch.tensor(coeffs).T)
    loose = 0
    for k, row in enumerate(coeffs):
        a, b, c, d = map(float, row)
        t_h, n_h = quartic_argmin(a, b, c, d)
        assert int(num[k]) == n_h, k
        t = float(tau[k])
        if t == pytest.approx(t_h, rel=1e-12, abs=1e-15):
            continue
        # three real roots, a small one found by cancellation against a
        # large one (row 277: roots 3549.8 and 0.776): torch's arccos / cos
        # and libm's differ in the last bit, and the cancellation makes that
        # 1.7e-10 of the root; phi is flat at its minimum, so the step's
        # value agrees to 1e-15 of its scale
        loose += 1
        assert t == pytest.approx(t_h, rel=1e-9), k

        def phi(x):
            return (((a * x + b) * x + c) * x + d) * x

        scale = abs(a) + abs(b) + abs(c) + abs(d)
        assert abs(phi(t) - phi(t_h)) <= 1e-15 * scale, k
    assert loose <= 2


def test_block_csr_keeps_duplicates_and_padding():
    rows, cols, vals, _ = _inputs()
    rows, cols, vals = rows[0], cols[0], vals[0]
    pairs = set()
    assert any((r, c) in pairs or pairs.add((r, c))
               for r, c in zip(rows, cols)), "the draws hold a duplicate"
    rows = np.concatenate([rows, [0, 0]])       # zero-valued padding
    cols = np.concatenate([cols, [0, 0]])
    vals = np.concatenate([vals, [0.0, 0.0]])
    csr = K.SymCSR.from_upper_coo(rows, cols, vals, N, "cpu")
    assert csr.nnz == rows.size + int(np.sum(rows != cols))
    C = np.zeros((N, N))
    np.add.at(C, (rows, cols), vals)
    off = rows != cols
    np.add.at(C, (cols[off], rows[off]), vals[off])
    Y = np.random.default_rng(2).normal(size=(N, 3))
    np.testing.assert_allclose(
        K.spmm_sym_csr(csr, torch.tensor(Y)).numpy(), C @ Y, rtol=1e-13,
        atol=1e-13)
