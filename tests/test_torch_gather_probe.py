"""K13 (``gather_rowsum``), the port of the repo's one ``pl.pallas_call``
(``scripts/pallas_gather_probe.py`` ``kern``), and its probe twin.

The probe script runs its measurement when imported, so its ``kern`` is read
from the file with ``ast`` and run through ``pl.pallas_call`` in interpret
mode on the CPU with the probe's own ``pltpu.VMEM`` specs, at a small size
(N = 256, M = 4,096, R = 8, tiles of 1,024).  The plain version must give
the same sums as ``kern`` and as the probe's XLA baseline ``f_xla``, to
float32 rounding (1e-5 of the largest sum: the three add the same float32
terms in different orders).  The kernel itself is held on the card in
``test_torch_kernels.py`` (``-m cuda``), which imports no JAX.
"""

import ast
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ltr_lowrank_sdp_torch.ops import kernels as K
from ltr_lowrank_sdp_torch.scripts import gather_probe

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROBE = ROOT / "scripts" / "pallas_gather_probe.py"
N, M, R, TILE = 256, 4096, 8, 1024
TOL = 1e-5


def _probe_kern():
    """``kern`` of the probe script, compiled from its own source."""
    tree = ast.parse(PROBE.read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "kern")
    ns = {"jnp": jnp, "pl": pl}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE), "exec"),
         ns)
    return ns["kern"]


def _inputs(n=N, m=M, r=R, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, r)).astype(np.float32),
            rng.integers(0, n, size=m).astype(np.int32))


def _pallas(Y, idx):
    kern = _probe_kern()
    n, r = Y.shape
    f = pl.pallas_call(
        kern, grid=(idx.size // TILE,),
        in_specs=[
            pl.BlockSpec((TILE,), lambda g: (g,), memory_space=pltpu.VMEM),
            pl.BlockSpec((n, r), lambda g: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, r), lambda g: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, r), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, r), jnp.float32)],
        interpret=True)
    return np.asarray(f(jnp.asarray(idx), jnp.asarray(Y)))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


def test_plain_version_matches_the_pallas_kern():
    Y, idx = _inputs()
    want = _pallas(Y, idx)
    exact = Y.astype(np.float64)[idx].sum(0, keepdims=True)
    _close(want, exact)
    got = K.gather_rowsum(torch.tensor(Y), torch.tensor(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, R)
    _close(got.numpy(), want)
    _close(got.numpy(), exact)


def test_plain_version_matches_the_probe_xla_baseline():
    Y, idx = _inputs(seed=1)
    f_xla = jax.jit(lambda y, i: y[i].sum(axis=0))     # the probe's f_xla
    want = np.asarray(f_xla(jnp.asarray(Y), jnp.asarray(idx)))[None]
    _close(K.gather_rowsum(torch.tensor(Y), torch.tensor(idx)).numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    Y, idx = _inputs()
    before = K.KERNELS["gather_rowsum"].plain_calls
    K.gather_rowsum(torch.tensor(Y), torch.tensor(idx))
    assert K.KERNELS["gather_rowsum"].plain_calls == before + 1


@pytest.mark.parametrize("M_", [0, 1, 255, 256, 257, 300_001])
def test_grid_covers_every_index_once(M_):
    blocks, tile = K.gather_rowsum_grid(M_)
    assert 1 <= blocks <= K.K13_MAX_BLOCKS
    assert blocks * tile >= M_ and (blocks - 1) * tile < max(M_, 1)


def test_probe_twin_cpu_line():
    out = subprocess.run(
        [sys.executable, "-m", "ltr_lowrank_sdp_torch.scripts.gather_probe",
         "256", "4096", "8", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"N", "M", "R", "torch_gather_ms", "kernel_ok",
            "kernel_gather_ms", "bound_ms", "gathered_bytes"} <= set(line)
    assert (line["N"], line["M"], line["R"]) == (256, 4096, 8)
    assert line["device"] == "cpu" and "plain" in line["path"]
    assert line["kernel_gather_ms"] is None and line["kernel_ok"] is None
    assert line["gathered_bytes"] == 4096 * 8 * 4
    assert line["bound_ms"] == pytest.approx(
        (4096 * 4 + 256 * 8 * 4 + 8 * 4) / 3.35e12 * 1e3)


def test_probe_twin_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.probe(256, 4096, 8)
