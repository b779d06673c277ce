"""The slice's four CUDA kernels, their plain PyTorch versions, and the build.

Each kernel lives in ``csrc/<name>.cu`` with a plain C entry point.  At first
use on a CUDA tensor the sources are compiled with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) into shared libraries under
``ltr_lowrank_sdp_torch/build/`` and loaded with :mod:`ctypes`.  A library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.

Every wrapper takes the plain PyTorch version for tensors on the CPU (the
tests' path) and launches its kernel for CUDA tensors on PyTorch's current
stream; it never falls back from one to the other.  Each :class:`Kernel`
counts its launches (``launches``) and its plain calls (``plain_calls``), so
a run can show which path it took.

=====  ====================  ==============================================
K      kernel                replaces (ltr_lowrank_sdp_tpu/...)
=====  ====================  ==============================================
K1     spmm_sym_csr          ops/gatherseg.py EllSpMM.apply (+ the
                             diag_identity ConeOps.apply_a row scale)
K2     diag_rowdot           ops/coneops.py ConeOps.constr_vals and
                             ConeOps.constr_vals_pair (diag_identity)
K3     diag_normal_matvec    ops/coneops.py ConeOps.cg_normal_matvec
                             (diag_identity)
K4     sym_contract_sum      ops/coneops.py ConeOps.obj_value (sparse C)
                             + ops/compsum.py csum
=====  ====================  ==============================================
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, its C symbol, its counters."""

    name: str
    replaces: str           # file:line of the TPU kernel it replaces
    argtypes: Tuple
    launches: int = 0       # kernel launches (CUDA tensors)
    plain_calls: int = 0    # plain PyTorch version calls (CPU tensors)
    lib_path: Optional[pathlib.Path] = None
    build_log: str = ""
    _fn: Optional[object] = None

    @property
    def source(self) -> pathlib.Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def symbol(self) -> str:
        return f"ltr_{self.name}"

    def fn(self):
        if self._fn is None:
            build_kernels()
            lib = ctypes.CDLL(str(self.lib_path))
            f = getattr(lib, self.symbol)
            f.argtypes = list(self.argtypes)
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def launch(self, *args) -> None:
        err = self.fn()(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: cudaError {err}")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("spmm_sym_csr",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:248",
           (_P, _P, _P, _P, _P, _P, _I, _I, _D, _P)),
    Kernel("diag_rowdot",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:231",
           (_P, _P, _P, _D, _P, _P, _I, _I, _P)),
    Kernel("diag_normal_matvec",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:272",
           (_P, _P, _P, _P, _I, _I, _P)),
    Kernel("sym_contract_sum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:332",
           (_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P)),
)}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_calls = 0


def counts() -> Dict[str, Tuple[int, int]]:
    """``{name: (launches, plain_calls)}``."""
    return {k.name: (k.launches, k.plain_calls) for k in KERNELS.values()}


# --------------------------------------------------------------------------- #
# build
# --------------------------------------------------------------------------- #


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the GPU")


def _lib_path(k: Kernel) -> pathlib.Path:
    h = hashlib.sha256(k.source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{k.name}-{h.hexdigest()[:12]}.so"


def build_kernels() -> List[str]:
    """Compile every kernel whose library is missing, all in parallel.

    Returns the names built by this call.  Raises with nvcc's output when a
    build fails."""
    todo = []
    for k in KERNELS.values():
        k.lib_path = _lib_path(k)
        if not k.lib_path.exists():
            todo.append(k)
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(k.source)]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for k, tmp, p in procs:
        out, _ = p.communicate()
        k.build_log = out
        if p.returncode != 0:
            failed.append(f"{k.name}:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, k.lib_path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [k.name for k, _, _ in procs]


# --------------------------------------------------------------------------- #
# validation helpers
# --------------------------------------------------------------------------- #


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _stream(device: torch.device) -> int:
    # the C entry points launch on the calling thread's current device
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} need it as the current device "
                         "(torch.cuda.set_device)")
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _i32(v: int, what: str) -> int:
    if v >= 2**31:
        raise ValueError(f"{what} = {v} does not fit the kernels' int32")
    return int(v)


# --------------------------------------------------------------------------- #
# K1: symmetric CSR SpMM (+ diagonal row scale)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class SymCSR:
    """A symmetric sparse matrix stored once as a full CSR (both triangles,
    diagonal once), built on the host from its upper-triangle COO."""

    n: int
    indptr: torch.Tensor     # (n+1,) int32
    indices: torch.Tensor    # (nnz,) int32
    vals: torch.Tensor       # (nnz,) float64
    row_ids: torch.Tensor    # (nnz,) int64 row of each stored entry (plain)

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    @staticmethod
    def from_upper_coo(rows, cols, vals, n: int, device,
                       dtype=torch.float64) -> "SymCSR":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        off = rows != cols
        r_all = np.concatenate([rows, cols[off]])
        c_all = np.concatenate([cols, rows[off]])
        v_all = np.concatenate([vals, vals[off]])
        order = np.lexsort((c_all, r_all))
        r_all, c_all, v_all = r_all[order], c_all[order], v_all[order]
        _i32(max(r_all.size, n + 1), "nnz of C")
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(r_all, minlength=n), out=indptr[1:])
        return SymCSR(
            n=n,
            indptr=torch.tensor(indptr, dtype=torch.int32, device=device),
            indices=torch.tensor(c_all, dtype=torch.int32, device=device),
            vals=torch.tensor(v_all, dtype=dtype, device=device),
            row_ids=torch.tensor(r_all, dtype=torch.int64, device=device))


def spmm_sym_csr_plain(csr: Optional[SymCSR], Y: torch.Tensor,
                       alpha: float = 1.0,
                       d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1: ``alpha * C @ Y + d[:, None] * Y``."""
    out = None
    if csr is not None:
        cy = torch.zeros_like(Y).index_add_(
            0, csr.row_ids, csr.vals[:, None] * Y[csr.indices.long()])
        out = alpha * cy
    if d is not None:
        dy = d[:, None] * Y
        out = dy if out is None else out + dy
    return out


def spmm_sym_csr(csr: Optional[SymCSR], Y: torch.Tensor, alpha: float = 1.0,
                 d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``alpha * C @ Y (+ d[:, None] * Y)`` for a static symmetric C.

    ``csr=None`` applies only the diagonal term (``d`` is then required)."""
    k = KERNELS["spmm_sym_csr"]
    if csr is None and d is None:
        raise ValueError("spmm_sym_csr needs C, d, or both")
    if _is_cpu(Y):
        k.plain_calls += 1
        return spmm_sym_csr_plain(csr, Y, alpha, d)
    dev = Y.device
    if Y.dim() != 2:
        raise ValueError(f"Y must be (n, r), got {tuple(Y.shape)}")
    n, r = Y.shape
    _check(Y, "Y", torch.float64, (n, r), dev)
    _i32(n * max(r, 1), "n * r")
    if csr is not None:
        if csr.n != n:
            raise ValueError(f"C is {csr.n} x {csr.n}, Y has {n} rows")
        _check(csr.indptr, "indptr", torch.int32, (n + 1,), dev)
        _check(csr.indices, "indices", torch.int32, (csr.nnz,), dev)
        _check(csr.vals, "vals", torch.float64, (csr.nnz,), dev)
    if d is not None:
        _check(d, "d", torch.float64, (n,), dev)
    out = torch.empty((n, r), dtype=torch.float64, device=dev)
    k.launch(_ptr(csr.indptr) if csr else None,
             _ptr(csr.indices) if csr else None,
             _ptr(csr.vals) if csr else None,
             Y.data_ptr(), _ptr(d), out.data_ptr(), n, r, float(alpha),
             _stream(dev))
    return out


# --------------------------------------------------------------------------- #
# K2: diagonal-constraint row dots (constr_vals / constr_vals_pair)
# --------------------------------------------------------------------------- #


def diag_rowdot_plain(U, V, dv, s: float = 1.0, second: bool = False):
    """Plain version of K2."""
    o1 = (s * dv) * torch.sum(U * V, dim=-1)
    if not second:
        return o1
    return o1, dv * torch.sum(V * V, dim=-1)


def diag_rowdot(U: torch.Tensor, V: torch.Tensor, dv: torch.Tensor,
                s: float = 1.0, second: bool = False):
    """K2: ``(s*dv) * rowsum(U*V)``, and with ``second`` also
    ``dv * rowsum(V*V)`` from the same pass."""
    k = KERNELS["diag_rowdot"]
    if _is_cpu(U):
        k.plain_calls += 1
        return diag_rowdot_plain(U, V, dv, s, second)
    dev = U.device
    if U.dim() != 2:
        raise ValueError(f"U must be (n, r), got {tuple(U.shape)}")
    n, r = U.shape
    _check(U, "U", torch.float64, (n, r), dev)
    _check(V, "V", torch.float64, (n, r), dev)
    _check(dv, "dv", torch.float64, (n,), dev)
    _i32(n * max(r, 1), "n * r")
    o1 = torch.empty(n, dtype=torch.float64, device=dev)
    o2 = torch.empty(n, dtype=torch.float64, device=dev) if second else None
    k.launch(U.data_ptr(), V.data_ptr(), dv.data_ptr(), float(s),
             o1.data_ptr(), _ptr(o2), n, r, _stream(dev))
    return (o1, o2) if second else o1


# --------------------------------------------------------------------------- #
# K3: ADMM normal-equation matvec
# --------------------------------------------------------------------------- #


def diag_normal_matvec_plain(x, F, dv):
    """Plain version of K3."""
    w = dv * torch.sum(x * F, dim=-1)
    return x + (dv * w)[:, None] * F


def diag_normal_matvec(x: torch.Tensor, F: torch.Tensor,
                       dv: torch.Tensor) -> torch.Tensor:
    """K3: ``x + (dv^2 * rowsum(x*F))[:, None] * F`` in one pass."""
    k = KERNELS["diag_normal_matvec"]
    if _is_cpu(x):
        k.plain_calls += 1
        return diag_normal_matvec_plain(x, F, dv)
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"x must be (n, r), got {tuple(x.shape)}")
    n, r = x.shape
    _check(x, "x", torch.float64, (n, r), dev)
    _check(F, "F", torch.float64, (n, r), dev)
    _check(dv, "dv", torch.float64, (n,), dev)
    _i32(n * max(r, 1), "n * r")
    y = torch.empty((n, r), dtype=torch.float64, device=dev)
    k.launch(x.data_ptr(), F.data_ptr(), dv.data_ptr(), y.data_ptr(), n, r,
             _stream(dev))
    return y


# --------------------------------------------------------------------------- #
# K4: <C, sym(U V^T)>
# --------------------------------------------------------------------------- #

_K4_WARPS_PER_BLOCK = 8     # matches kWarpsPerBlock in sym_contract_sum.cu
_K4_MAX_BLOCKS = 1024


def sym_contract_sum_plain(rows, cols, coef, U, V):
    """Plain version of K4."""
    rows = rows.long()
    cols = cols.long()
    if U is V:
        e = torch.sum(U[rows] * U[cols], dim=-1)
    else:
        e = 0.5 * (torch.sum(U[rows] * V[cols], dim=-1)
                   + torch.sum(U[cols] * V[rows], dim=-1))
    return torch.sum(coef * e)


def sym_contract_sum(rows: torch.Tensor, cols: torch.Tensor,
                     coef: torch.Tensor, U: torch.Tensor,
                     V: torch.Tensor) -> torch.Tensor:
    """K4: ``sum_k coef_k * sym(U V^T)[rows_k, cols_k]`` as a 0-dim float64
    tensor on U's device (``U is V`` reads U only)."""
    k = KERNELS["sym_contract_sum"]
    if _is_cpu(U):
        k.plain_calls += 1
        return sym_contract_sum_plain(rows, cols, coef, U, V)
    dev = U.device
    if U.dim() != 2:
        raise ValueError(f"U must be (n, r), got {tuple(U.shape)}")
    n, r = U.shape
    nnz = int(rows.numel())
    _check(U, "U", torch.float64, (n, r), dev)
    _check(V, "V", torch.float64, (n, r), dev)
    _check(rows, "rows", torch.int32, (nnz,), dev)
    _check(cols, "cols", torch.int32, (nnz,), dev)
    _check(coef, "coef", torch.float64, (nnz,), dev)
    _i32(n * max(r, 1), "n * r")
    nblocks = max(1, min(_K4_MAX_BLOCKS,
                         -(-nnz // _K4_WARPS_PER_BLOCK)))
    partials = torch.empty(nblocks, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float64, device=dev)
    k.launch(rows.data_ptr(), cols.data_ptr(), coef.data_ptr(), U.data_ptr(),
             V.data_ptr(), _i32(nnz, "nnz"), r, 1 if U is V else 0,
             partials.data_ptr(), nblocks, out.data_ptr(), _stream(dev))
    return out
