"""SDPA sparse-format reader.

A copy of ``ltr_lowrank_sdp_tpu/io/sdpa.py``.  Produces the raw block data
that :mod:`ltr_lowrank_sdp_torch.problem` canonicalizes into the solver's
representation.

Format semantics follow the reference reader ``LReadSDPA``
(``lorads/src/src_semi/io/lorads_file_io.c:59-456``):

* leading lines starting with ``*`` or ``"`` are comments;
* header = #constraints, #blocks, block dims, RHS vector b;
* a single trailing block with negative dimension is an LP (diagonal) block
  of ``-dim`` nonnegative columns (``:177-194``);
* entry lines are ``<constr> <block> <i> <j> <val>`` with 1-based indices;
  ``constr == 0`` is the objective, whose entries are **negated** so the
  solver minimizes ``<C, X>`` (``:300-320``);
* entries are stored as the upper triangle (``i <= j``); the implied matrix
  is symmetric, so off-diagonal entries count twice in inner products;
* entries with ``|val| < 1e-12`` are dropped with a warning (``:288-295``);
* duplicate (constr, i, j) entries sum (linearity of the conic operators).

The file is tokenized once and the entry section is parsed vectorized,
which is orders of magnitude faster than a per-line Python loop on large
instances.  The C++ streaming parser (:mod:`.native`, built with g++ at first
use) is faster still and is used when it builds.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional

import numpy as np

TINY_ENTRY = 1e-12


@dataclasses.dataclass
class SDPABlock:
    """Raw entries of one SDP block, split into objective and constraints."""

    dim: int
    # objective C entries (already negated: we minimize <C, X>)
    c_rows: np.ndarray  # int32, upper triangle (row <= col)
    c_cols: np.ndarray
    c_vals: np.ndarray  # float64
    # constraint entries, cid in [0, m)
    a_rows: np.ndarray
    a_cols: np.ndarray
    a_vals: np.ndarray
    a_cid: np.ndarray


@dataclasses.dataclass
class SDPAData:
    """Parsed SDPA instance: SDP blocks + optional trailing LP block."""

    n_constrs: int
    blocks: List[SDPABlock]
    b: np.ndarray  # (m,) float64 RHS
    n_lp_cols: int = 0
    # LP block data: objective coefficients (negated) and constraint entries
    lp_c: Optional[np.ndarray] = None       # (n_lp_cols,) float64
    lp_col: Optional[np.ndarray] = None     # entry -> LP column index
    lp_cid: Optional[np.ndarray] = None     # entry -> constraint id [0, m)
    lp_vals: Optional[np.ndarray] = None

    @property
    def block_dims(self) -> List[int]:
        return [blk.dim for blk in self.blocks]


def _dedupe_sum(rows, cols, vals, extra=None):
    """Sum duplicate (extra, row, col) entries; returns sorted arrays."""
    if extra is None:
        key = rows.astype(np.int64) * (cols.max() + 1 if cols.size else 1) + cols
        order = np.argsort(key, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        key = key[order]
        uniq, idx = np.unique(key, return_index=True)
        if uniq.size == rows.size:
            return rows, cols, vals
        summed = np.add.reduceat(vals, idx)
        return rows[idx], cols[idx], summed
    # with extra (constraint id) leading key
    nmax = int(max(rows.max(), cols.max())) + 1 if rows.size else 1
    key = (extra.astype(np.int64) * nmax + rows.astype(np.int64)) * nmax + cols
    order = np.argsort(key, kind="stable")
    rows, cols, vals, extra = rows[order], cols[order], vals[order], extra[order]
    key = key[order]
    uniq, idx = np.unique(key, return_index=True)
    if uniq.size == rows.size:
        return rows, cols, vals, extra
    summed = np.add.reduceat(vals, idx)
    return rows[idx], cols[idx], summed, extra[idx]


def read_sdpa(path: str | os.PathLike, use_native: bool = True) -> SDPAData:
    """Parse an SDPA sparse (.dat-s) file.

    Uses the native C++ streaming parser when it builds; otherwise warns
    with the build's failure (:func:`.native.build_error`) and uses the
    vectorized Python tokenizer.  A file the native parser rejects is read
    again by the Python tokenizer, as the JAX package does.  Both share the
    same canonicalization (negation / triangle swap / dedup)."""
    if use_native:
        from . import native

        try:
            raw = native.parse_raw(str(path))
        except ValueError:
            raw = None
        else:
            if raw is None:
                warnings.warn("native SDPA parser unavailable ("
                              f"{native.build_error()}); using the Python "
                              "tokenizer")
        if raw is not None:
            dims_arr, n_lp, b, cid, blk, row, col, val = raw
            return _postprocess(
                [int(x) for x in dims_arr], n_lp, b,
                cid.astype(np.int64), blk.astype(np.int64),
                row.astype(np.int64), col.astype(np.int64), val,
            )
    return _read_sdpa_python(path)


def _read_sdpa_python(path: str | os.PathLike) -> SDPAData:
    with open(path, "r") as f:
        text = f.read()

    # Cut at the optional trailing comment sentinel (file_io.c:273-276).
    sentinel = text.find("BEGIN.COMMENT")
    if sentinel >= 0:
        text = text[:sentinel]

    # Skip leading comment lines, then flatten the rest to one token stream.
    lines = text.split("\n")
    i = 0
    while i < len(lines) and (
        lines[i].lstrip().startswith("*")
        or lines[i].lstrip().startswith('"')
        or not lines[i].strip()
    ):
        i += 1
    body = "\n".join(lines[i:])
    # Braces / parens / commas / quotes are separators in the header section.
    # ('+' must survive: exponents like 1.0e+01 are common in entry values.)
    for ch in "{}(),'":
        body = body.replace(ch, " ")
    tokens = body.split()

    pos = 0
    m = int(float(tokens[pos])); pos += 1
    n_blocks = int(float(tokens[pos])); pos += 1
    dims = [int(float(tokens[pos + k])) for k in range(n_blocks)]
    pos += n_blocks

    n_lp_cols = 0
    if dims and dims[-1] < 0:
        # Trailing negative block is the LP cone (file_io.c:177-194); only one
        # diagonal block is supported and it must be last.
        n_lp_cols = -dims[-1]
        dims = dims[:-1]
        n_blocks -= 1
    if any(d <= 0 for d in dims):
        raise ValueError("only one diagonal (LP) block, at the end, is supported")

    b = np.array([float(tokens[pos + k]) for k in range(m)], dtype=np.float64)
    pos += m

    ent = np.array(tokens[pos:], dtype=np.float64)
    if ent.size % 5 != 0:
        raise ValueError(f"entry section not a multiple of 5 tokens ({ent.size})")
    ent = ent.reshape(-1, 5)
    cid = ent[:, 0].astype(np.int64)           # 0 = objective
    blk = ent[:, 1].astype(np.int64) - 1       # 0-based block
    row = ent[:, 2].astype(np.int64) - 1
    col = ent[:, 3].astype(np.int64) - 1
    val = ent[:, 4]
    return _postprocess(dims, n_lp_cols, b, cid, blk, row, col, val)


def _postprocess(dims, n_lp_cols, b, cid, blk, row, col, val) -> SDPAData:
    """Shared canonicalization for both parser backends."""
    m = b.size
    n_blocks = len(dims)

    tiny = np.abs(val) < TINY_ENTRY
    if tiny.any():
        warnings.warn("SDPA entries smaller than 1e-12 are ignored")
        keep = ~tiny
        cid, blk, row, col, val = cid[keep], blk[keep], row[keep], col[keep], val[keep]

    # store upper triangle: row <= col
    swap = row > col
    row2 = np.where(swap, col, row)
    col2 = np.where(swap, row, col)
    row, col = row2, col2

    # objective entries are negated (minimize <C,X>)
    is_obj = cid == 0
    val = np.where(is_obj, -val, val)

    blocks: List[SDPABlock] = []
    lp_block_id = n_blocks  # after removing the trailing LP dim
    for k in range(n_blocks):
        sel = blk == k
        bo = sel & is_obj
        ba = sel & ~is_obj
        c_rows, c_cols, c_vals = _dedupe_sum(
            row[bo].astype(np.int32), col[bo].astype(np.int32), val[bo]
        ) if bo.any() else (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0))
        if ba.any():
            a_rows, a_cols, a_vals, a_cid = _dedupe_sum(
                row[ba].astype(np.int32), col[ba].astype(np.int32), val[ba],
                extra=(cid[ba] - 1).astype(np.int32),
            )
        else:
            a_rows = a_cols = a_cid = np.zeros(0, np.int32)
            a_vals = np.zeros(0)
        blocks.append(
            SDPABlock(
                dim=dims[k],
                c_rows=c_rows, c_cols=c_cols, c_vals=np.asarray(c_vals, np.float64),
                a_rows=a_rows, a_cols=a_cols,
                a_vals=np.asarray(a_vals, np.float64),
                a_cid=np.asarray(a_cid, np.int32),
            )
        )

    data = SDPAData(n_constrs=m, blocks=blocks, b=b, n_lp_cols=n_lp_cols)
    if n_lp_cols > 0:
        sel = blk == lp_block_id
        if (row[sel] != col[sel]).any():
            raise ValueError("LP (diagonal) block has off-diagonal entries")
        lp_obj = sel & is_obj
        lp_con = sel & ~is_obj
        lp_c = np.zeros(n_lp_cols, dtype=np.float64)
        np.add.at(lp_c, row[lp_obj], val[lp_obj])
        data.lp_c = lp_c
        data.lp_col = row[lp_con].astype(np.int32)
        data.lp_cid = (cid[lp_con] - 1).astype(np.int32)
        data.lp_vals = val[lp_con].astype(np.float64)
    return data
