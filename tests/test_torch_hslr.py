"""The port's HSLR and hybrid-SDPA readers against the JAX package's, on
small files written here with sparse (SP) and low-rank (LR) parts: identical
arrays, identical dense matrices and identical spectraplex problems."""

import numpy as np
import pytest

from ltr_lowrank_sdp_torch.hallar import solver as TS
from ltr_lowrank_sdp_torch.io import hslr as th
from ltr_lowrank_sdp_tpu.hallar import solver as JS
from ltr_lowrank_sdp_tpu.io import hslr as jh

# C = I + 10 v v^T (SP + LR, one LR row with its S entry), A_1 sparse only,
# A_2 low rank only (two LR rows, S = diag(1, 2)), A_3 both parts, with an
# LR row given without S (V only) after one with S
HSLR_TEXT = """\
3 4
2 4 4
5

0 SP
1 1 1
2 2 1
3 3 1
4 4 1
0 LR
1 10 1 1 ; 10
1 SP
1 2 1
4 3 0.5
2 SP
2 LR
1 0 1 0 ; 1 0
0 1 0 1 ; 0 2
3 SP
1 3 -1
2 4 -1
3 LR
1 0 1 0 ; 1 0
0 1 0 1 ; 0 1
"""

# one block of dimension 3: C sparse, A_1 sparse, A_2 = P diag(D) P^T of
# rank 2 plus a sparse entry
HYBRID_TEXT = """\
m = 2
nBlocks = 1
blockStruct = 3
lowrank_struct = -1 -1 2
c = 1.5 -2

0 1 1 1 1.0
0 1 3 2 0.25
1 1 1 1 1.0
1 1 2 2 1.0
2 1 1 3 -0.5
2 P 1 1 1 1.0
2 P 1 2 2 2.0
2 P 1 3 1 -1.0
2 D 1 1 3.0
2 D 1 2 0.5
"""


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _same_matrix(a, b):
    for f in ("n", "sp_rows", "sp_cols", "sp_vals", "lr_V", "lr_S"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.dense(), b.dense())


@pytest.mark.parametrize("kind", ["hslr", "hybrid"])
def test_reader_matches_the_jax_package(tmp_path, kind):
    if kind == "hslr":
        path = _write(tmp_path, "p.hslr", HSLR_TEXT)
        got, ref = th.read_hslr(path), jh.read_hslr(path)
    else:
        path = _write(tmp_path, "p.dat-s", HYBRID_TEXT)
        got, ref = th.read_hybrid_sdpa(path), jh.read_hybrid_sdpa(path)
    assert (got.m, got.n) == (ref.m, ref.n)
    np.testing.assert_array_equal(got.b, ref.b)
    assert got.tau == ref.tau or (np.isnan(got.tau) and np.isnan(ref.tau))
    assert len(got.A) == len(ref.A) == got.m
    _same_matrix(got.C, ref.C)
    for a, b in zip(got.A, ref.A):
        _same_matrix(a, b)


def test_hslr_dense_matrices():
    """What the file says, written out: C = I + 10 v v^T, A_2 = V^T S V."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/p.hslr"
        with open(path, "w") as fh:
            fh.write(HSLR_TEXT)
        data = th.read_hslr(path)
    v = np.array([1.0, 10.0, 1.0, 1.0])
    np.testing.assert_array_equal(data.C.dense(), np.eye(4) + 10 * np.outer(v, v))
    V = np.array([[1.0, 0, 1, 0], [0, 1, 0, 1]])
    np.testing.assert_array_equal(data.A[1].dense(),
                                  V.T @ np.diag([1.0, 2.0]) @ V)
    assert data.tau == 5.0


@pytest.mark.parametrize("kind", ["hslr", "hybrid"])
def test_spectraplex_problem_from_file_matches(tmp_path, kind):
    if kind == "hslr":
        path = _write(tmp_path, "p.hslr", HSLR_TEXT)
        got = TS.SpectraplexProblem.from_hslr(path)
        ref = JS.SpectraplexProblem.from_hslr(path)
    else:
        path = _write(tmp_path, "p.dat-s", HYBRID_TEXT)
        got = TS.SpectraplexProblem.from_hslr_data(
            th.read_hybrid_sdpa(path), tau=3.0)
        ref = JS.SpectraplexProblem.from_hslr_data(
            jh.read_hybrid_sdpa(path), tau=3.0)
        with pytest.raises(ValueError, match="trace bound"):
            TS.SpectraplexProblem.from_hslr_data(th.read_hybrid_sdpa(path))
    for f in ("n", "m", "tau"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("b", "c_rows", "c_cols", "c_vals", "a_rows", "a_cols",
              "a_vals", "a_cid"):
        x, y = getattr(got, f), getattr(ref, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("text, what", [
    (HSLR_TEXT.replace("2 4 4", "2 4"), "RHS"),
    (HSLR_TEXT.split("3 SP")[0], "matrices"),      # A_3 missing
])
def test_malformed_hslr_raises_as_the_jax_package_does(tmp_path, text, what):
    path = _write(tmp_path, "bad.hslr", text)
    with pytest.raises(ValueError, match=what):
        jh.read_hslr(path)
    with pytest.raises(ValueError, match=what):
        th.read_hslr(path)
