"""HSLR format reader — hybrid sparse + low-rank matrix blocks.

A copy of ``ltr_lowrank_sdp_tpu/io/hslr.py`` (pure numpy): the port keeps
its own so that it imports nothing of the JAX package.

The HALLaR binary's input format (``hallar/src/examples/
hybrid_hslr_format_v2.hslr``; described in ``hallar/src/README.md``):

    m n
    b_1 ... b_m
    tau                     (trace bound)
    <for each matrix id 0..m  (0 = objective C)>
    <id> SP
    i j v                   (1-based symmetric triplets, any number of lines)
    <id> LR
    v_1 ... v_n ; s_1 ... s_r    (line l: row l of V and row l of S)

Each matrix is  M = SP_part + V^T S V  where V is (r x n) from the LR lines
(entries before ';') and S is (r x r) from the entries after ';'.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HSLRMatrix:
    n: int
    sp_rows: np.ndarray
    sp_cols: np.ndarray
    sp_vals: np.ndarray
    lr_V: Optional[np.ndarray] = None   # (r, n)
    lr_S: Optional[np.ndarray] = None   # (r, r)

    def dense(self) -> np.ndarray:
        M = np.zeros((self.n, self.n))
        for r, c, v in zip(self.sp_rows, self.sp_cols, self.sp_vals):
            M[r, c] += v
            if r != c:
                M[c, r] += v
        if self.lr_V is not None and self.lr_V.size:
            M = M + self.lr_V.T @ self.lr_S @ self.lr_V
        return M


@dataclasses.dataclass
class HSLRData:
    m: int
    n: int
    b: np.ndarray
    tau: float
    C: HSLRMatrix
    A: List[HSLRMatrix]


def read_hslr(path: str) -> HSLRData:
    with open(path) as f:
        lines = [ln.rstrip() for ln in f]

    idx = 0

    def next_nonempty():
        nonlocal idx
        while idx < len(lines) and not lines[idx].strip():
            idx += 1
        ln = lines[idx]
        idx += 1
        return ln

    hdr = next_nonempty().split()
    m, n = int(hdr[0]), int(hdr[1])
    b = np.array([float(x) for x in next_nonempty().split()], np.float64)
    if b.size != m:
        raise ValueError(f"HSLR: expected {m} RHS values, got {b.size}")
    tau = float(next_nonempty().split()[0])

    mats: List[HSLRMatrix] = []
    cur_id = None
    mode = None
    sp: List[Tuple[int, int, float]] = []
    lr_v: List[List[float]] = []
    lr_s: List[List[float]] = []

    def flush():
        nonlocal sp, lr_v, lr_s
        if cur_id is None:
            return
        V = np.array(lr_v, np.float64) if lr_v else None
        S = np.array(lr_s, np.float64) if lr_s else None
        if V is not None and S is not None and S.shape != (V.shape[0],) * 2:
            raise ValueError("HSLR: LR S block shape mismatch")
        rows = np.array([t[0] for t in sp], np.int32)
        cols = np.array([t[1] for t in sp], np.int32)
        vals = np.array([t[2] for t in sp], np.float64)
        mats.append(HSLRMatrix(n=n, sp_rows=rows, sp_cols=cols, sp_vals=vals,
                               lr_V=V, lr_S=S))
        sp, lr_v, lr_s = [], [], []

    while idx < len(lines):
        ln = lines[idx].strip()
        idx += 1
        if not ln:
            continue
        toks = ln.split()
        if len(toks) == 2 and toks[1] in ("SP", "LR"):
            if toks[1] == "SP":
                flush()
                cur_id = int(toks[0])
            mode = toks[1]
            continue
        if mode == "SP":
            i, j, v = int(toks[0]) - 1, int(toks[1]) - 1, float(toks[2])
            if i > j:
                i, j = j, i
            sp.append((i, j, v))
        elif mode == "LR":
            if ";" in ln:
                left, right = ln.split(";")
                lr_v.append([float(x) for x in left.split()])
                lr_s.append([float(x) for x in right.split()])
            else:
                lr_v.append([float(x) for x in toks])
    flush()

    if len(mats) != m + 1:
        raise ValueError(f"HSLR: expected {m + 1} matrices, got {len(mats)}")
    return HSLRData(m=m, n=n, b=b, tau=tau, C=mats[0], A=mats[1:])


def read_hybrid_sdpa(path: str) -> HSLRData:
    """Reader for HALLaR's labeled hybrid SDPA variant
    (``hallar/src/examples/toy_hybrid_single_block.dat-s``):

        m = 4
        nBlocks = 1
        blockStruct = 3
        lowrank_struct = -1 -1 -1 -1 1     (-1 sparse, k>=1 rank-k LR)
        c = -1 -1 -1 -1                    (RHS vector)
        <matid> <blk> <i> <j> <v>          sparse entries (1-based, matid 0=C)
        <matid> P <blk> <row> <col> <v>    LR factor P entries
        <matid> D <blk> <idx> <v>          LR diagonal weights
                                           (matrix = P diag(D) P^T)

    Single-block only.  The format carries no trace bound; ``tau`` is
    returned as nan and must be supplied by the caller (CLI --trace_bound /
    options.cfg, cf. examples/suggested_trace_bounds.txt).
    """
    hdr = {}
    entries = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            if "=" in ln:
                k, v = ln.split("=", 1)
                hdr[k.strip()] = v.strip()
            else:
                entries.append(ln.split())
    m = int(hdr["m"])
    if int(hdr.get("nBlocks", "1")) != 1:
        raise ValueError("hybrid SDPA reader supports a single block")
    n = int(hdr["blockStruct"].split()[0])
    b = np.array([float(x) for x in hdr["c"].split()], np.float64)
    if b.size != m:
        raise ValueError(f"hybrid SDPA: expected {m} RHS values, got {b.size}")

    sp = {i: [] for i in range(m + 1)}
    lr_p = {}
    lr_d = {}
    for toks in entries:
        mid = int(toks[0])
        if toks[1] == "P":
            _, row, col, v = toks[2], int(toks[3]), int(toks[4]), float(toks[5])
            lr_p.setdefault(mid, []).append((row - 1, col - 1, v))
        elif toks[1] == "D":
            _, idx, v = toks[2], int(toks[3]), float(toks[4])
            lr_d.setdefault(mid, []).append((idx - 1, v))
        else:
            i, j, v = int(toks[2]) - 1, int(toks[3]) - 1, float(toks[4])
            if i > j:
                i, j = j, i
            sp[mid].append((i, j, v))

    mats = []
    for mid in range(m + 1):
        rows = np.array([t[0] for t in sp[mid]], np.int32)
        cols = np.array([t[1] for t in sp[mid]], np.int32)
        vals = np.array([t[2] for t in sp[mid]], np.float64)
        V = S = None
        if mid in lr_p:
            rank = max(c for _, c, _ in lr_p[mid]) + 1
            P = np.zeros((n, rank))
            for r, c, v in lr_p[mid]:
                P[r, c] = v
            d = np.zeros(rank)
            for idx2, v in lr_d.get(mid, []):
                d[idx2] = v
            V = P.T                       # (r, n), matrix = V^T diag(d) V
            S = np.diag(d)
        mats.append(HSLRMatrix(n=n, sp_rows=rows, sp_cols=cols,
                               sp_vals=vals, lr_V=V, lr_S=S))
    return HSLRData(m=m, n=n, b=b, tau=float("nan"), C=mats[0], A=mats[1:])
