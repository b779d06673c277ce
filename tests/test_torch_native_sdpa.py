"""The port's native SDPA parser against its Python reader and the JAX
package's ``read_sdpa``: identical arrays on the format's edge cases and on
one file of each generator family, the same errors, and where it builds.
"""

import pathlib
import warnings

import numpy as np
import pytest

from ltr_lowrank_sdp_torch.io import native, sdpa
from ltr_lowrank_sdp_torch.scripts.gen_instances import gen_maxcut
from ltr_lowrank_sdp_torch.testing import (matcomp_sdpa, multiblock_lp_sdpa,
                                           same_sdpa, theta_sdpa, write_sdpa)
from ltr_lowrank_sdp_tpu.io.sdpa import read_sdpa as jax_read_sdpa

ROOT = pathlib.Path(__file__).resolve().parent.parent

TOY = """\
* toy problem
2
2
2 2
1.0 2.0
0 1 1 1 1.0
0 1 1 2 2.0
0 2 1 1 3.0
1 1 1 1 1.0
1 2 2 2 1.0
2 1 1 2 0.5
2 2 1 1 1.0
"""

LP_BLOCK = """\
2
2
2 -3
1.0 2.0
0 1 1 1 1.0
0 2 1 1 5.0
1 1 1 1 1.0
1 2 2 2 2.0
2 2 3 3 1.0
"""

DUPLICATES = """\
1
1
2
1.0
1 1 1 2 1.0
1 1 2 1 2.0
"""

# quoted and starred comment lines and blank lines before the header, a
# lower-triangle entry, exponents, and the trailing comment sentinel
COMMENTS = """\
"a quoted comment line
   * an indented starred one

3
1
3
1.0e+00 -2.5E-01 3
0 1 1 1 -1.0e+01
0 1 3 2 2.5
1 1 1 1 1.0
2 1 2 3 -0.25
3 1 3 3 1e0
BEGIN.COMMENT
0 1 2 2 99.0 (ignored past the sentinel)
"""

# the header in braces, parentheses and commas, as SDPA writers emit it
BRACES = """\
2
2
{2, 3}
{1.0, -1.0}
0 1 1 2 0.5
0 2 3 3 1.0
1 1 1 1 1.0
1 2 2 3 1.0
2 2 1 1 -1.0
2 1 2 2 1.0
"""

# an entry below the drop threshold (1e-12) beside one above it
TINY = """\
1
1
2
1.0
1 1 1 1 1e-13
1 1 2 2 2e-12
0 1 1 2 1.0
"""

TOYS = {"toy": TOY, "lp_block": LP_BLOCK, "duplicates": DUPLICATES,
        "comments": COMMENTS, "braces": BRACES, "tiny": TINY}


def _write(tmp_path, text, name="toy.dat-s"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _three_ways(path):
    """(native, Python, JAX package) readings of one file."""
    assert native.available(), native.build_error()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the tiny entries' warning
        return (sdpa.read_sdpa(path), sdpa.read_sdpa(path, use_native=False),
                jax_read_sdpa(path))


@pytest.mark.parametrize("case", sorted(TOYS))
def test_toy_cases_read_alike(tmp_path, case):
    got, py, ref = _three_ways(_write(tmp_path, TOYS[case]))
    assert same_sdpa(got, py)
    assert same_sdpa(got, ref)


def test_toy_cases_parse_as_the_format_says(tmp_path):
    data = sdpa.read_sdpa(_write(tmp_path, COMMENTS))
    np.testing.assert_array_equal(data.b, [1.0, -0.25, 3.0])
    blk = data.blocks[0]
    # the objective negated, the (3, 2) entry swapped into the upper
    # triangle, nothing read past BEGIN.COMMENT
    assert list(zip(blk.c_rows, blk.c_cols, blk.c_vals)) == [
        (0, 0, 10.0), (1, 2, -2.5)]
    assert blk.a_cid.tolist() == [0, 1, 2]
    data = sdpa.read_sdpa(_write(tmp_path, BRACES))
    assert data.block_dims == [2, 3]
    np.testing.assert_array_equal(data.b, [1.0, -1.0])
    with pytest.warns(UserWarning, match="1e-12"):
        data = sdpa.read_sdpa(_write(tmp_path, TINY))
    assert data.blocks[0].a_vals.tolist() == [2e-12]


@pytest.mark.parametrize("family", ["maxcut", "matcomp", "multiblock_lp",
                                    "theta"])
def test_generator_files_read_alike(tmp_path, family):
    path = str(tmp_path / f"{family}.dat-s")
    if family == "maxcut":
        gen_maxcut(300, 6, 3, path)
    else:
        write_sdpa(path, {
            "matcomp": lambda: matcomp_sdpa(40, 50, 2, 2.0, 1),
            "multiblock_lp": lambda: multiblock_lp_sdpa((12, 9, 7), 30, 50, 2),
            "theta": lambda: theta_sdpa(30, 7, 30)}[family]())
    got, py, ref = _three_ways(path)
    assert same_sdpa(got, py)
    assert same_sdpa(got, ref)
    if family == "multiblock_lp":
        assert got.n_lp_cols == 50 and len(got.blocks) == 3


@pytest.mark.parametrize("text,match", [
    ("abc\n1\n2\n1.0\n", "native SDPA parse failed: bad header"),
    ("1\n2\n-2 3\n1.0\n1 1 1 1 1.0\n", "LP"),
])
def test_malformed_files_raise_value_error(tmp_path, text, match):
    path = _write(tmp_path, text)
    with pytest.raises(ValueError, match=match):
        native.parse_raw(path)
    with pytest.raises(ValueError):
        sdpa._read_sdpa_python(path)
    with pytest.raises(ValueError):
        sdpa.read_sdpa(path)


def _fresh_build_state(monkeypatch, build_dir):
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", None)


def test_the_build_writes_only_under_the_build_directory(monkeypatch,
                                                         tmp_path):
    assert native.BUILD_DIR == ROOT / "ltr_lowrank_sdp_torch" / "build"
    src_dir = native.SRC.parent
    before = sorted(p.name for p in src_dir.iterdir())
    _fresh_build_state(monkeypatch, tmp_path / "build")
    assert native.available(), native.build_error()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        native.lib_path().name]
    assert native.lib_path().name.startswith("libsdpa_parser-")
    assert sorted(p.name for p in src_dir.iterdir()
                  if p.name != "__pycache__") == [
        n for n in before if n != "__pycache__"]
    assert not list(src_dir.glob("*.so"))


def test_without_gxx_the_python_reader_runs(monkeypatch, tmp_path):
    path = _write(tmp_path, TOY)
    want = sdpa.read_sdpa(path, use_native=False)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    _fresh_build_state(monkeypatch, tmp_path / "build")
    assert not native.available()
    assert "g++" in native.build_error()
    assert native.parse_raw(path) is None
    with pytest.warns(UserWarning, match="native SDPA parser unavailable"):
        got = sdpa.read_sdpa(path)
    assert same_sdpa(got, want)
    assert not (tmp_path / "build").exists()
