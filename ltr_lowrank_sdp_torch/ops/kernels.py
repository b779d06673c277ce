"""The port's eight CUDA kernels, their plain PyTorch versions, and the build.

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
K5     coo_contract_segsum   ops/gatherseg.py EllSegSum.__call__ fused with
                             ops/coneops.py ConeOps.constr_vals and
                             ConeOps.constr_vals_pair (sparse A and
                             non-identity diag), and the first half of
                             their ConeOps.cg_normal_matvec
K6     spmm_constr_csr       ops/gatherseg.py EllSpMM.apply_constr via
                             ConeOps.apply_a / apply_w (sparse A and
                             non-identity diag), and the second half of
                             their ConeOps.cg_normal_matvec
K7     lp_constr_segsum      ops/coneops.py LPOps.constr_vals (the LP cone's
                             A_lp(u o v), an EllSegSum over constraints)
K8     lp_col_wsum           ops/coneops.py LPOps.weighted_col_sums (the LP
                             cone's c0 c + A_lp^T w, an EllSegSum over
                             columns)
=====  ====================  ==============================================

K1-K4 carry the MaxCut family (one diagonal constraint per row); K5 and K6
carry every other SDP cone (sparse or dense constraint kind), with K1 and K4
for a sparse objective and ``torch.matmul`` for a dense one; K7 and K8 carry
the LP cone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
    Kernel("coo_contract_segsum",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:143",
           (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
            _I, _P, _I, _P, _P, _I, _P, _P, _P)),
    Kernel("spmm_constr_csr",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:256",
           (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _P)),
    Kernel("lp_constr_segsum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:435",
           (_P, _P, _P, _P, _P, _I, _I, _P, _P, _P)),
    Kernel("lp_col_wsum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:443",
           (_P, _P, _P, _P, _P, _D, _I, _P, _P)),
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


def _ids_from_ptr(ptr: torch.Tensor) -> torch.Tensor:
    """The int64 segment (or row) id of every entry of a CSR-like layout,
    from its pointer array.  Only the plain versions index with it, so the
    layouts derive it at first use and the kernels' path never holds it."""
    ptr = ptr.long()
    return torch.repeat_interleave(
        torch.arange(ptr.numel() - 1, device=ptr.device), ptr[1:] - ptr[:-1])


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

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    @functools.cached_property
    def row_ids(self) -> torch.Tensor:
        """(nnz,) int64 row of each stored entry (plain version only)."""
        return _ids_from_ptr(self.indptr)

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
            vals=torch.tensor(v_all, dtype=dtype, device=device))


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


# --------------------------------------------------------------------------- #
# K5: A(sym(U V^T)) for general sparse constraints (contraction + segment sum)
# --------------------------------------------------------------------------- #


K5_LONG_SEGMENT = 32     # a segment of at least this many entries is cut
K5_CHUNK = 8             # into chunks of at most this many entries


@dataclasses.dataclass
class SegCOO:
    """The upper-triangle entries of a cone's constraint matrices, sorted by
    constraint id on the host: the entries of constraint i are the segment
    ``seg_ptr[i]:seg_ptr[i+1]``.  ``coef`` counts an off-diagonal entry twice
    (``<A, X>`` for symmetric X).

    A segment of at least ``long_thresh`` entries (a trace constraint) is cut
    into chunks of at most ``K5_CHUNK`` entries that the kernel reduces with
    one warp each and then adds in chunk order: ``chunk_ptr[c]`` is chunk c's
    (start, end), ``long_seg`` the cut segments and ``long_ptr`` their chunk
    ranges.  All three are None when no segment is that long."""

    n: int
    m: int
    seg_ptr: torch.Tensor    # (m+1,) int32
    rows: torch.Tensor       # (nnz,) int32
    cols: torch.Tensor       # (nnz,) int32
    coef: torch.Tensor       # (nnz,) float64
    long_thresh: int = K5_LONG_SEGMENT
    chunk_ptr: Optional[torch.Tensor] = None    # (n_chunks, 2) int32
    long_seg: Optional[torch.Tensor] = None     # (n_long,) int32
    long_ptr: Optional[torch.Tensor] = None     # (n_long+1,) int32

    @property
    def nnz(self) -> int:
        return int(self.rows.numel())

    @property
    def n_chunks(self) -> int:
        return 0 if self.chunk_ptr is None else int(self.chunk_ptr.shape[0])

    @functools.cached_property
    def seg_ids(self) -> torch.Tensor:
        """(nnz,) int64 constraint of each entry (plain version only)."""
        return _ids_from_ptr(self.seg_ptr)

    @staticmethod
    def from_coo(rows, cols, vals, cid, n: int, m: int, device,
                 dtype=torch.float64,
                 long_thresh: Optional[int] = K5_LONG_SEGMENT) -> "SegCOO":
        """``long_thresh=None`` builds the layout without the long-segment
        split (every segment one warp's walk).  No solver path asks for
        that: it is a hook for the tests and the smoke run, which hold the
        split against the unsplit walk and time both."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        cid = np.asarray(cid, np.int64)
        _i32(max(rows.size, m + 1, n), "nnz of A")
        order = np.argsort(cid, kind="stable")
        rows, cols = rows[order], cols[order]
        vals = vals[order]
        seg_ptr = np.zeros(m + 1, np.int64)
        np.cumsum(np.bincount(cid, minlength=m), out=seg_ptr[1:])
        coef = np.where(rows != cols, 2.0 * vals, vals)
        seg = SegCOO(
            n=n, m=m,
            seg_ptr=torch.tensor(seg_ptr, dtype=torch.int32, device=device),
            rows=torch.tensor(rows, dtype=torch.int32, device=device),
            cols=torch.tensor(cols, dtype=torch.int32, device=device),
            coef=torch.tensor(coef, dtype=dtype, device=device))
        lens = np.diff(seg_ptr)
        long_seg = (np.flatnonzero(lens >= long_thresh) if long_thresh
                    else np.zeros(0, np.int64))
        if long_seg.size:
            per = -(-lens[long_seg] // K5_CHUNK)
            long_ptr = np.zeros(long_seg.size + 1, np.int64)
            np.cumsum(per, out=long_ptr[1:])
            which = np.repeat(np.arange(long_seg.size), per)
            start = (seg_ptr[long_seg][which]
                     + (np.arange(long_ptr[-1]) - long_ptr[:-1][which])
                     * K5_CHUNK)
            end = np.minimum(start + K5_CHUNK, seg_ptr[long_seg + 1][which])
            seg.long_thresh = int(long_thresh)
            seg.chunk_ptr = torch.tensor(np.stack([start, end], axis=1),
                                         dtype=torch.int32, device=device)
            seg.long_seg = torch.tensor(long_seg, dtype=torch.int32,
                                        device=device)
            seg.long_ptr = torch.tensor(long_ptr, dtype=torch.int32,
                                        device=device)
        return seg


def coo_contract_segsum_plain(seg: SegCOO, U, V, pair: bool = False):
    """Plain version of K5."""
    rows, cols = seg.rows.long(), seg.cols.long()

    def segsum(e):
        return torch.zeros(seg.m, dtype=e.dtype, device=e.device).index_add_(
            0, seg.seg_ids, seg.coef * e)

    if pair:
        Vr, Vc = V[rows], V[cols]
        e_uv = (torch.sum(U[rows] * Vc, dim=-1)
                + torch.sum(U[cols] * Vr, dim=-1))
        return segsum(e_uv), segsum(torch.sum(Vr * Vc, dim=-1))
    if U is V:
        return segsum(torch.sum(U[rows] * U[cols], dim=-1))
    return segsum(0.5 * (torch.sum(U[rows] * V[cols], dim=-1)
                         + torch.sum(U[cols] * V[rows], dim=-1)))


def coo_contract_segsum(seg: SegCOO, U: torch.Tensor, V: torch.Tensor,
                        pair: bool = False):
    """K5: per constraint i, ``sum_k coef_k * sym(U V^T)[rows_k, cols_k]``
    over its entries -> (m,) (``U is V`` reads U only); with ``pair`` the two
    vectors ``(A(2 sym(U V^T)), A(V V^T))`` from one read of the rows."""
    k = KERNELS["coo_contract_segsum"]
    if _is_cpu(U):
        k.plain_calls += 1
        return coo_contract_segsum_plain(seg, U, V, pair)
    dev = U.device
    if U.dim() != 2:
        raise ValueError(f"U must be (n, r), got {tuple(U.shape)}")
    n, r = U.shape
    if n != seg.n or r < 1:
        raise ValueError(f"the cone has {seg.n} rows, U is {tuple(U.shape)}")
    _check(U, "U", torch.float64, (n, r), dev)
    _check(V, "V", torch.float64, (n, r), dev)
    _check(seg.seg_ptr, "seg_ptr", torch.int32, (seg.m + 1,), dev)
    _check(seg.rows, "rows", torch.int32, (seg.nnz,), dev)
    _check(seg.cols, "cols", torch.int32, (seg.nnz,), dev)
    _check(seg.coef, "coef", torch.float64, (seg.nnz,), dev)
    _i32(n * r, "n * r")
    mode = 2 if pair else (1 if U is V else 0)
    o1 = torch.empty(seg.m, dtype=torch.float64, device=dev)
    o2 = torch.empty(seg.m, dtype=torch.float64, device=dev) if pair else None
    nc = seg.n_chunks
    n_long = 0
    part = None
    if nc:
        n_long = int(seg.long_seg.numel())
        _check(seg.chunk_ptr, "chunk_ptr", torch.int32, (nc, 2), dev)
        _check(seg.long_seg, "long_seg", torch.int32, (n_long,), dev)
        _check(seg.long_ptr, "long_ptr", torch.int32, (n_long + 1,), dev)
        part = torch.empty((2, nc), dtype=torch.float64, device=dev)
    k.launch(seg.seg_ptr.data_ptr(), seg.rows.data_ptr(), seg.cols.data_ptr(),
             seg.coef.data_ptr(), U.data_ptr(), V.data_ptr(), seg.m, r, mode,
             o1.data_ptr(), _ptr(o2), seg.long_thresh, _ptr(seg.chunk_ptr),
             nc, _ptr(seg.long_seg), _ptr(seg.long_ptr), n_long,
             _ptr(part), part[1].data_ptr() if nc else None, _stream(dev))
    return (o1, o2) if pair else o1


# --------------------------------------------------------------------------- #
# K6: (sum_i w_i A_i) Y over the symmetrized constraint pattern (+ beta Z)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class ConstrCSR:
    """All constraint entries of a cone as one full symmetric CSR (both
    triangles, a diagonal entry once), built on the host from the
    upper-triangle COO.  Every slot keeps the id of its constraint, so
    entries of different constraints at one (row, col) stay separate."""

    n: int
    m: int
    indptr: torch.Tensor     # (n+1,) int32
    indices: torch.Tensor    # (nnz,) int32
    vals: torch.Tensor       # (nnz,) float64
    cid: torch.Tensor        # (nnz,) int32

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    @functools.cached_property
    def row_ids(self) -> torch.Tensor:
        """(nnz,) int64 row of each slot (plain version only)."""
        return _ids_from_ptr(self.indptr)

    @staticmethod
    def from_upper_coo(rows, cols, vals, cid, n: int, m: int, device,
                       dtype=torch.float64) -> "ConstrCSR":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        cid = np.asarray(cid, np.int64)
        off = rows != cols
        r_all = np.concatenate([rows, cols[off]])
        c_all = np.concatenate([cols, rows[off]])
        v_all = np.concatenate([vals, vals[off]])
        k_all = np.concatenate([cid, cid[off]])
        _i32(max(r_all.size, n + 1, m), "nnz of A")
        order = np.lexsort((k_all, c_all, r_all))
        r_all, c_all = r_all[order], c_all[order]
        v_all, k_all = v_all[order], k_all[order]
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(r_all, minlength=n), out=indptr[1:])
        return ConstrCSR(
            n=n, m=m,
            indptr=torch.tensor(indptr, dtype=torch.int32, device=device),
            indices=torch.tensor(c_all, dtype=torch.int32, device=device),
            vals=torch.tensor(v_all, dtype=dtype, device=device),
            cid=torch.tensor(k_all, dtype=torch.int32, device=device))


def spmm_constr_csr_plain(csr: ConstrCSR, w, Y, Z=None, beta: float = 1.0):
    """Plain version of K6."""
    wt = w[csr.cid.long()] * csr.vals
    out = torch.zeros_like(Y).index_add_(
        0, csr.row_ids, wt[:, None] * Y[csr.indices.long()])
    return out if Z is None else beta * Z + out


def spmm_constr_csr(csr: ConstrCSR, w: torch.Tensor, Y: torch.Tensor,
                    Z: Optional[torch.Tensor] = None,
                    beta: float = 1.0) -> torch.Tensor:
    """K6: ``(sum_i w_i A_i) @ Y (+ beta * Z)`` with per-slot weight
    ``w[cid] * val`` gathered inside the kernel."""
    k = KERNELS["spmm_constr_csr"]
    if _is_cpu(Y):
        k.plain_calls += 1
        return spmm_constr_csr_plain(csr, w, Y, Z, beta)
    dev = Y.device
    if Y.dim() != 2:
        raise ValueError(f"Y must be (n, r), got {tuple(Y.shape)}")
    n, r = Y.shape
    if n != csr.n or r < 1:
        raise ValueError(f"the cone has {csr.n} rows, Y is {tuple(Y.shape)}")
    _check(Y, "Y", torch.float64, (n, r), dev)
    _check(w, "w", torch.float64, (csr.m,), dev)
    if Z is not None:
        _check(Z, "Z", torch.float64, (n, r), dev)
    _check(csr.indptr, "indptr", torch.int32, (n + 1,), dev)
    _check(csr.indices, "indices", torch.int32, (csr.nnz,), dev)
    _check(csr.vals, "vals", torch.float64, (csr.nnz,), dev)
    _check(csr.cid, "cid", torch.int32, (csr.nnz,), dev)
    _i32(n * r, "n * r")
    out = torch.empty((n, r), dtype=torch.float64, device=dev)
    k.launch(csr.indptr.data_ptr(), csr.indices.data_ptr(),
             csr.vals.data_ptr(), csr.cid.data_ptr(), w.data_ptr(),
             Y.data_ptr(), _ptr(Z), out.data_ptr(), n, r, float(beta),
             _stream(dev))
    return out


# --------------------------------------------------------------------------- #
# K7 / K8: the LP cone's two segment sums
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class LPEntries:
    """The LP cone's constraint entries (column, constraint, value) in two
    static orders built once on the host, each a stable sort of the problem's
    own entry order: by constraint (a CSR over the m constraints, for K7) and
    by column (a CSC over the n_cols columns, for K8), with the LP objective
    ``c``."""

    m: int
    n_cols: int
    c: torch.Tensor          # (n_cols,) float64
    row_ptr: torch.Tensor    # (m+1,) int32
    row_col: torch.Tensor    # (nnz,) int32, column of each entry, CSR order
    row_val: torch.Tensor    # (nnz,) float64
    col_ptr: torch.Tensor    # (n_cols+1,) int32
    col_cid: torch.Tensor    # (nnz,) int32, constraint of each entry, CSC order
    col_val: torch.Tensor    # (nnz,) float64

    @property
    def nnz(self) -> int:
        return int(self.row_col.numel())

    @functools.cached_property
    def row_ids(self) -> torch.Tensor:
        """(nnz,) int64 constraint of each CSR entry (plain version only)."""
        return _ids_from_ptr(self.row_ptr)

    @functools.cached_property
    def col_ids(self) -> torch.Tensor:
        """(nnz,) int64 column of each CSC entry (plain version only)."""
        return _ids_from_ptr(self.col_ptr)

    @staticmethod
    def from_coo(c, col, cid, vals, m: int, n_cols: int, device,
                 dtype=torch.float64) -> "LPEntries":
        col = np.asarray(col, np.int64)
        cid = np.asarray(cid, np.int64)
        vals = np.asarray(vals, np.float64)
        _i32(max(col.size, m + 1, n_cols + 1), "nnz of the LP cone")

        def ptr(ids, size):
            out = np.zeros(size + 1, np.int64)
            np.cumsum(np.bincount(ids, minlength=size), out=out[1:])
            return torch.tensor(out, dtype=torch.int32, device=device)

        by_cid = np.argsort(cid, kind="stable")
        by_col = np.argsort(col, kind="stable")
        return LPEntries(
            m=m, n_cols=n_cols,
            c=torch.tensor(np.asarray(c, np.float64), dtype=dtype,
                           device=device),
            row_ptr=ptr(cid, m),
            row_col=torch.tensor(col[by_cid], dtype=torch.int32,
                                 device=device),
            row_val=torch.tensor(vals[by_cid], dtype=dtype, device=device),
            col_ptr=ptr(col, n_cols),
            col_cid=torch.tensor(cid[by_col], dtype=torch.int32,
                                 device=device),
            col_val=torch.tensor(vals[by_col], dtype=dtype, device=device))


def lp_constr_segsum_plain(lp: LPEntries, u, v, pair: bool = False):
    """Plain version of K7."""
    cols = lp.row_col.long()

    def segsum(x):
        return torch.zeros(lp.m, dtype=x.dtype, device=x.device).index_add_(
            0, lp.row_ids, lp.row_val * x[cols])

    if pair:
        return 2.0 * segsum(u * v), segsum(v * v)
    return segsum(u * v)


def lp_constr_segsum(lp: LPEntries, u: torch.Tensor, v: torch.Tensor,
                     pair: bool = False):
    """K7: per constraint i, ``sum_e val_e * u[col_e] * v[col_e]`` over its LP
    entries -> (m,); with ``pair`` the two vectors ``(2 A_lp(u o v),
    A_lp(v o v))`` from one pass."""
    k = KERNELS["lp_constr_segsum"]
    if _is_cpu(u):
        k.plain_calls += 1
        return lp_constr_segsum_plain(lp, u, v, pair)
    dev = u.device
    _check(u, "u", torch.float64, (lp.n_cols,), dev)
    _check(v, "v", torch.float64, (lp.n_cols,), dev)
    _check(lp.row_ptr, "row_ptr", torch.int32, (lp.m + 1,), dev)
    _check(lp.row_col, "row_col", torch.int32, (lp.nnz,), dev)
    _check(lp.row_val, "row_val", torch.float64, (lp.nnz,), dev)
    o1 = torch.empty(lp.m, dtype=torch.float64, device=dev)
    o2 = torch.empty(lp.m, dtype=torch.float64, device=dev) if pair else None
    k.launch(lp.row_ptr.data_ptr(), lp.row_col.data_ptr(),
             lp.row_val.data_ptr(), u.data_ptr(), v.data_ptr(), lp.m,
             2 if pair else 0, o1.data_ptr(), _ptr(o2), _stream(dev))
    return (o1, o2) if pair else o1


def lp_col_wsum_plain(lp: LPEntries, w, c0: float = 1.0):
    """Plain version of K8."""
    s = torch.zeros(lp.n_cols, dtype=w.dtype, device=w.device).index_add_(
        0, lp.col_ids, lp.col_val * w[lp.col_cid.long()])
    return c0 * lp.c + s


def lp_col_wsum(lp: LPEntries, w: torch.Tensor,
                c0: float = 1.0) -> torch.Tensor:
    """K8: per LP column j, ``c0 * c[j] + sum_e val_e * w[cid_e]`` over its
    entries -> (n_cols,), the weight gather inside the kernel."""
    k = KERNELS["lp_col_wsum"]
    if _is_cpu(w):
        k.plain_calls += 1
        return lp_col_wsum_plain(lp, w, c0)
    dev = w.device
    _check(w, "w", torch.float64, (lp.m,), dev)
    _check(lp.c, "c", torch.float64, (lp.n_cols,), dev)
    _check(lp.col_ptr, "col_ptr", torch.int32, (lp.n_cols + 1,), dev)
    _check(lp.col_cid, "col_cid", torch.int32, (lp.nnz,), dev)
    _check(lp.col_val, "col_val", torch.float64, (lp.nnz,), dev)
    out = torch.empty(lp.n_cols, dtype=torch.float64, device=dev)
    k.launch(lp.col_ptr.data_ptr(), lp.col_cid.data_ptr(),
             lp.col_val.data_ptr(), w.data_ptr(), lp.c.data_ptr(), float(c0),
             lp.n_cols, out.data_ptr(), _stream(dev))
    return out
