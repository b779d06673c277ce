"""ctypes bindings and the build at first use of the native SDPA parser.

A copy of ``ltr_lowrank_sdp_tpu/io/native`` whose library is built with g++
into the package's ``build/`` directory (never beside the source), named by
a hash of the source and the flags, so an edited source builds anew.  When
the build fails (no g++), :func:`available` is false, :func:`build_error`
says why, and :func:`..sdpa.read_sdpa` warns and reads the file with its
Python tokenizer, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "sdpa_parser.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_BUILD_ERROR: Optional[str] = None


def lib_path() -> pathlib.Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsdpa_parser-{h.hexdigest()[:12]}.so"


def _build(out: pathlib.Path) -> Optional[str]:
    """Compile the parser into ``out``; the failure's reason, or None."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found on PATH"
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError as e:
        return f"cannot write {BUILD_DIR}: {e}"
    os.close(fd)
    try:
        p = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        return f"g++ failed: {e}"
    if p.returncode != 0:
        os.unlink(tmp)
        return f"g++ failed ({p.returncode}): {p.stderr.strip()}"
    os.replace(tmp, out)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The parser's library, built at the first call; None if the build
    failed (the reason in :func:`build_error`)."""
    global _LIB, _BUILD_ERROR
    if _LIB is not None:
        return _LIB
    if _BUILD_ERROR is not None:
        return None
    path = lib_path()
    if not path.exists():
        _BUILD_ERROR = _build(path)
        if _BUILD_ERROR is not None:
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _BUILD_ERROR = f"cannot load {path.name}: {e}"
        return None
    lib.sdpa_open.restype = ctypes.c_void_p
    lib.sdpa_open.argtypes = [ctypes.c_char_p]
    lib.sdpa_error.restype = ctypes.c_char_p
    lib.sdpa_error.argtypes = [ctypes.c_void_p]
    lib.sdpa_counts.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int64)] * 4
    lib.sdpa_dims.argtypes = [ctypes.c_void_p,
                              np.ctypeslib.ndpointer(np.int64)]
    lib.sdpa_rhs.argtypes = [ctypes.c_void_p,
                             np.ctypeslib.ndpointer(np.float64)]
    lib.sdpa_entries.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64),
    ]
    lib.sdpa_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native parser is built (building it if needed)."""
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the native parser is unavailable, or None."""
    get_lib()
    return _BUILD_ERROR


def parse_raw(path: str):
    """Returns (dims, n_lp, b, cid, blk, row, col, val) or None if the
    native library is unavailable; raises ValueError on a malformed
    header."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.sdpa_open(str(path).encode())
    try:
        err = lib.sdpa_error(h)
        if err:
            raise ValueError(f"native SDPA parse failed: {err.decode()}")
        m = ctypes.c_int64()
        nb = ctypes.c_int64()
        nlp = ctypes.c_int64()
        nnz = ctypes.c_int64()
        lib.sdpa_counts(h, ctypes.byref(m), ctypes.byref(nb),
                        ctypes.byref(nlp), ctypes.byref(nnz))
        dims = np.zeros(nb.value, np.int64)
        if nb.value:
            lib.sdpa_dims(h, dims)
        b = np.zeros(m.value, np.float64)
        if m.value:
            lib.sdpa_rhs(h, b)
        n = nnz.value
        cid = np.zeros(n, np.int32)
        blk = np.zeros(n, np.int32)
        row = np.zeros(n, np.int32)
        col = np.zeros(n, np.int32)
        val = np.zeros(n, np.float64)
        if n:
            lib.sdpa_entries(h, cid, blk, row, col, val)
        return dims, int(nlp.value), b, cid, blk, row, col, val
    finally:
        lib.sdpa_close(h)
