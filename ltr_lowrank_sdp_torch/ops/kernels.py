"""The port's thirteen CUDA kernels, their plain PyTorch versions, and the build.

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
a run can show which path it took; K1-K8 take float32 or float64 values (the
solver's compute dtype) and also count their float32 launches
(``launches_f32``, :func:`counts_f32`).

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
K9     gatv2_softmax_agg     models/gatv2.py segment_softmax and the
                             segment_sum aggregation of GATv2Conv (float32)
K10    graph_pool            models/net.py mean / max pooling and
                             models/layers.py AttentionPooling's segment
                             softmax and weighted sum (float32)
K11    gatv2_softmax_agg_bwd the VJP of K9's function, which
                             jax.value_and_grad takes in train.py (float32)
K12    graph_pool_bwd        the VJP of K10's function (float32)
K13    gather_rowsum         scripts/pallas_gather_probe.py kern, the one
                             pl.pallas_call: the column sum of
                             index-gathered rows (float32)
=====  ====================  ==============================================

K1-K4 carry the MaxCut family (one diagonal constraint per row); K5 and K6
carry every other SDP cone (sparse or dense constraint kind), with K1 and K4
for a sparse objective and ``torch.matmul`` for a dense one; K7 and K8 carry
the LP cone.  K1-K8 are templates on the value type: float64, or float32 for
the solver's ``dtype="float32"`` (K4 then still forms its products and sums
in float64).  K9 and K10 carry the rank-schedule predictor's graph encoder
at any width up to 256 channels (:func:`gatv2_lanes`, ``K10_MAX_D``),
and K11 and K12 its training backward pass: K9 + K11 and K10 + K12 are each
one ``torch.autograd.Function`` (:func:`gatv2_softmax_agg`, :func:`graph_pool`
when an input requires a gradient), with a plain backward beside the plain
forward for the CPU.
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
_F = ctypes.c_float


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, its C symbol, its counters."""

    name: str
    replaces: str           # file:line of the TPU kernel it replaces
    argtypes: Tuple
    typed: bool = False     # first C argument: 1 for float32 values (K1-K8)
    launches: int = 0       # kernel launches (CUDA tensors)
    launches_f32: int = 0   # of which on float32 values
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
        if self.typed and args[0]:
            self.launches_f32 += 1


KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("spmm_sym_csr",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:248",
           (_I, _P, _P, _P, _P, _P, _P, _I, _I, _D, _P), typed=True),
    Kernel("diag_rowdot",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:231",
           (_I, _P, _P, _P, _D, _P, _P, _I, _I, _P), typed=True),
    Kernel("diag_normal_matvec",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:272",
           (_I, _P, _P, _P, _P, _I, _I, _P), typed=True),
    Kernel("sym_contract_sum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:332",
           (_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P), typed=True),
    Kernel("coo_contract_segsum",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:143",
           (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
            _I, _P, _I, _P, _P, _I, _P, _P, _P), typed=True),
    Kernel("spmm_constr_csr",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:256",
           (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _P), typed=True),
    Kernel("lp_constr_segsum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:435",
           (_I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P), typed=True),
    Kernel("lp_col_wsum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:443",
           (_I, _P, _P, _P, _P, _P, _D, _I, _P, _P), typed=True),
    Kernel("gatv2_softmax_agg",
           "ltr_lowrank_sdp_tpu/models/gatv2.py:26",
           (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P,
            _P)),
    Kernel("graph_pool",
           "ltr_lowrank_sdp_tpu/models/layers.py:93",
           (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P)),
    Kernel("gatv2_softmax_agg_bwd",
           "ltr_lowrank_sdp_tpu/models/gatv2.py:26 (VJP, train.py:250)",
           (_P,) * 14 + (_I, _I, _I, _I, _F) + (_P,) * 8),
    Kernel("graph_pool_bwd",
           "ltr_lowrank_sdp_tpu/models/layers.py:93 (VJP, train.py:250)",
           (_P,) * 11 + (_I, _I) + (_P,) * 3),
    Kernel("gather_rowsum",
           "scripts/pallas_gather_probe.py:41",
           (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P)),
)}


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.launches_f32 = 0
        k.plain_calls = 0


def counts() -> Dict[str, Tuple[int, int]]:
    """``{name: (launches, plain_calls)}``."""
    return {k.name: (k.launches, k.plain_calls) for k in KERNELS.values()}


def counts_f32() -> Dict[str, int]:
    """``{name: launches on float32 values}`` of K1-K8."""
    return {k.name: k.launches_f32 for k in KERNELS.values() if k.typed}


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


def _value_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """The value type K1-K8 take, float32 or float64; every other value
    operand of the call is then checked against it."""
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or "
                        "float64")
    return t.dtype


def _f32(dtype: torch.dtype) -> int:
    """The C entry points' first argument: 1 for float32 values."""
    return int(dtype == torch.float32)


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


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an int64 index vector (the plain versions' gathers;
    ``index_select`` is the same copy at half the cost of indexing on the
    CPU)."""
    return torch.index_select(x, 0, idx)


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
    vals: torch.Tensor       # (nnz,) float64 or float32

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
    dt = _value_dtype(Y, "Y")
    _check(Y, "Y", dt, (n, r), dev)
    _i32(n * max(r, 1), "n * r")
    if csr is not None:
        if csr.n != n:
            raise ValueError(f"C is {csr.n} x {csr.n}, Y has {n} rows")
        _check(csr.indptr, "indptr", torch.int32, (n + 1,), dev)
        _check(csr.indices, "indices", torch.int32, (csr.nnz,), dev)
        _check(csr.vals, "vals", dt, (csr.nnz,), dev)
    if d is not None:
        _check(d, "d", dt, (n,), dev)
    out = torch.empty((n, r), dtype=dt, device=dev)
    k.launch(_f32(dt), _ptr(csr.indptr) if csr else None,
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
    dt = _value_dtype(U, "U")
    _check(U, "U", dt, (n, r), dev)
    _check(V, "V", dt, (n, r), dev)
    _check(dv, "dv", dt, (n,), dev)
    _i32(n * max(r, 1), "n * r")
    o1 = torch.empty(n, dtype=dt, device=dev)
    o2 = torch.empty(n, dtype=dt, device=dev) if second else None
    k.launch(_f32(dt), U.data_ptr(), V.data_ptr(), dv.data_ptr(), float(s),
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
    dt = _value_dtype(x, "x")
    _check(x, "x", dt, (n, r), dev)
    _check(F, "F", dt, (n, r), dev)
    _check(dv, "dv", dt, (n,), dev)
    _i32(n * max(r, 1), "n * r")
    y = torch.empty((n, r), dtype=dt, device=dev)
    k.launch(_f32(dt), x.data_ptr(), F.data_ptr(), dv.data_ptr(), y.data_ptr(), n, r,
             _stream(dev))
    return y


# --------------------------------------------------------------------------- #
# K4: <C, sym(U V^T)>
# --------------------------------------------------------------------------- #

_K4_WARPS_PER_BLOCK = 8     # matches kWarpsPerBlock in sym_contract_sum.cu
_K4_MAX_BLOCKS = 1024


def sym_contract_sum_plain(rows, cols, coef, U, V):
    """Plain version of K4: float64 products and sums of the (float32 or
    float64) inputs -> a 0-dim float64 tensor."""
    rows = rows.long()
    cols = cols.long()
    same = U is V
    U, V, coef = U.double(), V.double(), coef.double()
    if same:
        e = torch.sum(_rows(U, rows) * _rows(U, cols), dim=-1)
    else:
        e = 0.5 * (torch.sum(_rows(U, rows) * _rows(V, cols), dim=-1)
                   + torch.sum(_rows(U, cols) * _rows(V, rows), dim=-1))
    return torch.sum(coef * e)


def sym_contract_sum(rows: torch.Tensor, cols: torch.Tensor,
                     coef: torch.Tensor, U: torch.Tensor,
                     V: torch.Tensor) -> torch.Tensor:
    """K4: ``sum_k coef_k * sym(U V^T)[rows_k, cols_k]`` as a 0-dim float64
    tensor on U's device (``U is V`` reads U only).  float32 inputs are
    multiplied and summed in float64 (the contract of the reference's
    ``csum`` on float32, ``ltr_lowrank_sdp_tpu/ops/compsum.py:78``); the
    caller rounds the result to its compute type."""
    k = KERNELS["sym_contract_sum"]
    if _is_cpu(U):
        k.plain_calls += 1
        return sym_contract_sum_plain(rows, cols, coef, U, V)
    dev = U.device
    if U.dim() != 2:
        raise ValueError(f"U must be (n, r), got {tuple(U.shape)}")
    n, r = U.shape
    nnz = int(rows.numel())
    dt = _value_dtype(U, "U")
    _check(U, "U", dt, (n, r), dev)
    _check(V, "V", dt, (n, r), dev)
    _check(rows, "rows", torch.int32, (nnz,), dev)
    _check(cols, "cols", torch.int32, (nnz,), dev)
    _check(coef, "coef", dt, (nnz,), dev)
    _i32(n * max(r, 1), "n * r")
    nblocks = max(1, min(_K4_MAX_BLOCKS,
                         -(-nnz // _K4_WARPS_PER_BLOCK)))
    partials = torch.empty(nblocks, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float64, device=dev)
    k.launch(_f32(dt), rows.data_ptr(), cols.data_ptr(), coef.data_ptr(),
             U.data_ptr(),
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
    coef: torch.Tensor       # (nnz,) float64 or float32
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

    @functools.cached_property
    def rows64(self) -> torch.Tensor:
        """``rows`` as int64 (plain version only)."""
        return self.rows.long()

    @functools.cached_property
    def cols64(self) -> torch.Tensor:
        """``cols`` as int64 (plain version only)."""
        return self.cols.long()

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
    rows, cols = seg.rows64, seg.cols64

    def segsum(e):
        return torch.zeros(seg.m, dtype=e.dtype, device=e.device).index_add_(
            0, seg.seg_ids, seg.coef * e)

    if pair:
        Vr, Vc = _rows(V, rows), _rows(V, cols)
        e_uv = (torch.sum(_rows(U, rows) * Vc, dim=-1)
                + torch.sum(_rows(U, cols) * Vr, dim=-1))
        return segsum(e_uv), segsum(torch.sum(Vr * Vc, dim=-1))
    if U is V:
        return segsum(torch.sum(_rows(U, rows) * _rows(U, cols), dim=-1))
    return segsum(0.5 * (torch.sum(_rows(U, rows) * _rows(V, cols), dim=-1)
                         + torch.sum(_rows(U, cols) * _rows(V, rows),
                                     dim=-1)))


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
    dt = _value_dtype(U, "U")
    _check(U, "U", dt, (n, r), dev)
    _check(V, "V", dt, (n, r), dev)
    _check(seg.seg_ptr, "seg_ptr", torch.int32, (seg.m + 1,), dev)
    _check(seg.rows, "rows", torch.int32, (seg.nnz,), dev)
    _check(seg.cols, "cols", torch.int32, (seg.nnz,), dev)
    _check(seg.coef, "coef", dt, (seg.nnz,), dev)
    _i32(n * r, "n * r")
    mode = 2 if pair else (1 if U is V else 0)
    o1 = torch.empty(seg.m, dtype=dt, device=dev)
    o2 = torch.empty(seg.m, dtype=dt, device=dev) if pair else None
    nc = seg.n_chunks
    n_long = 0
    part = None
    if nc:
        n_long = int(seg.long_seg.numel())
        _check(seg.chunk_ptr, "chunk_ptr", torch.int32, (nc, 2), dev)
        _check(seg.long_seg, "long_seg", torch.int32, (n_long,), dev)
        _check(seg.long_ptr, "long_ptr", torch.int32, (n_long + 1,), dev)
        part = torch.empty((2, nc), dtype=dt, device=dev)
    k.launch(_f32(dt), seg.seg_ptr.data_ptr(), seg.rows.data_ptr(), seg.cols.data_ptr(),
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
    vals: torch.Tensor       # (nnz,) float64 or float32
    cid: torch.Tensor        # (nnz,) int32

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    @functools.cached_property
    def row_ids(self) -> torch.Tensor:
        """(nnz,) int64 row of each slot (plain version only)."""
        return _ids_from_ptr(self.indptr)

    @functools.cached_property
    def indices64(self) -> torch.Tensor:
        """``indices`` as int64 (plain version only)."""
        return self.indices.long()

    @functools.cached_property
    def cid64(self) -> torch.Tensor:
        """``cid`` as int64 (plain version only)."""
        return self.cid.long()

    @staticmethod
    def from_upper_coo(rows, cols, vals, cid, n: int, m: int, device,
                       dtype=torch.float64,
                       row_range: Optional[Tuple[int, int]] = None
                       ) -> "ConstrCSR":
        """``row_range=(lo, hi)`` keeps only the slots of rows lo..hi-1 (one
        rank's share of a sharded SpMM); every other row is empty and K6
        writes 0 there.  A kept row holds its slots in the same order as in
        the full layout, so its output is the full layout's, bit for bit."""
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
        if row_range is not None:
            keep = (r_all >= row_range[0]) & (r_all < row_range[1])
            r_all, c_all = r_all[keep], c_all[keep]
            v_all, k_all = v_all[keep], k_all[keep]
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
    wt = _rows(w, csr.cid64) * csr.vals
    out = torch.zeros_like(Y).index_add_(
        0, csr.row_ids, wt[:, None] * _rows(Y, csr.indices64))
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
    dt = _value_dtype(Y, "Y")
    _check(Y, "Y", dt, (n, r), dev)
    _check(w, "w", dt, (csr.m,), dev)
    if Z is not None:
        _check(Z, "Z", dt, (n, r), dev)
    _check(csr.indptr, "indptr", torch.int32, (n + 1,), dev)
    _check(csr.indices, "indices", torch.int32, (csr.nnz,), dev)
    _check(csr.vals, "vals", dt, (csr.nnz,), dev)
    _check(csr.cid, "cid", torch.int32, (csr.nnz,), dev)
    _i32(n * r, "n * r")
    out = torch.empty((n, r), dtype=dt, device=dev)
    k.launch(_f32(dt), csr.indptr.data_ptr(), csr.indices.data_ptr(),
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
    c: torch.Tensor          # (n_cols,) float64 or float32
    row_ptr: torch.Tensor    # (m+1,) int32
    row_col: torch.Tensor    # (nnz,) int32, column of each entry, CSR order
    row_val: torch.Tensor    # (nnz,) float64 or float32
    col_ptr: torch.Tensor    # (n_cols+1,) int32
    col_cid: torch.Tensor    # (nnz,) int32, constraint of each entry, CSC order
    col_val: torch.Tensor    # (nnz,) float64 or float32

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
    dt = _value_dtype(u, "u")
    _check(u, "u", dt, (lp.n_cols,), dev)
    _check(v, "v", dt, (lp.n_cols,), dev)
    _check(lp.row_ptr, "row_ptr", torch.int32, (lp.m + 1,), dev)
    _check(lp.row_col, "row_col", torch.int32, (lp.nnz,), dev)
    _check(lp.row_val, "row_val", dt, (lp.nnz,), dev)
    o1 = torch.empty(lp.m, dtype=dt, device=dev)
    o2 = torch.empty(lp.m, dtype=dt, device=dev) if pair else None
    k.launch(_f32(dt), lp.row_ptr.data_ptr(), lp.row_col.data_ptr(),
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
    dt = _value_dtype(w, "w")
    _check(w, "w", dt, (lp.m,), dev)
    _check(lp.c, "c", dt, (lp.n_cols,), dev)
    _check(lp.col_ptr, "col_ptr", torch.int32, (lp.n_cols + 1,), dev)
    _check(lp.col_cid, "col_cid", torch.int32, (lp.nnz,), dev)
    _check(lp.col_val, "col_val", dt, (lp.nnz,), dev)
    out = torch.empty(lp.n_cols, dtype=dt, device=dev)
    k.launch(_f32(dt), lp.col_ptr.data_ptr(), lp.col_cid.data_ptr(),
             lp.col_val.data_ptr(), w.data_ptr(), lp.c.data_ptr(), float(c0),
             lp.n_cols, out.data_ptr(), _stream(dev))
    return out


# --------------------------------------------------------------------------- #
# K9: GATv2 edge softmax and aggregation, K11: its backward (float32)
# --------------------------------------------------------------------------- #

K9_MAX_WIDTH = 256      # heads * channels: 8 channels per lane, 32 lanes
K9_MAX_PER_LANE = 8
K11_MAX_PARTS = 1024    # block partials of K11's first launch (kMaxBlocks)
LEAKY_SLOPE = 0.2


@dataclasses.dataclass
class EdgeCSR:
    """A graph's edges with a self-loop appended for every node, as a CSR over
    destinations, built on the edges' own device.  The edges of node i are
    ``indptr[i]:indptr[i+1]`` of ``src`` / ``erow`` in the order of the edge
    list with the loops last (a stable sort by destination; duplicate edges
    stay separate edges).  ``erow`` is the edge's row of the edge terms, or
    ``n_real`` for a self-loop (the one shared loop row)."""

    n: int
    n_real: int
    indptr: torch.Tensor     # (n+1,) int32
    src: torch.Tensor        # (n_real + n,) int32
    erow: torch.Tensor       # (n_real + n,) int32

    @property
    def n_slots(self) -> int:
        return self.n_real + self.n

    @functools.cached_property
    def dst_ids(self) -> torch.Tensor:
        """(n_real + n,) int64 destination of each slot (plain version
        only)."""
        return _ids_from_ptr(self.indptr)

    @functools.cached_property
    def by_src(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The same slots as a CSR over sources, for K11: ``(src_ptr (n+1,),
        src_slot (n_real + n,))`` int32, the slots of source j in increasing
        slot order at ``src_slot[src_ptr[j]:src_ptr[j+1]]``.  Built at first
        use and shared by the layers of one batch."""
        src = self.src.long()
        src_ptr = torch.zeros(self.n + 1, dtype=torch.long,
                              device=src.device)
        torch.cumsum(torch.bincount(src, minlength=self.n), 0,
                     out=src_ptr[1:])
        return (src_ptr.int(),
                torch.argsort(src, stable=True).int())

    @staticmethod
    def from_edge_index(edge_index: torch.Tensor, n: int) -> "EdgeCSR":
        """``edge_index`` (2, E): row 0 the sources, row 1 the
        destinations."""
        dev = edge_index.device
        e = int(edge_index.shape[1])
        _i32(max(e + n, n + 1), "edges + self-loops")
        loop = torch.arange(n, device=dev)
        src = torch.cat([edge_index[0].long(), loop])
        dst = torch.cat([edge_index[1].long(), loop])
        erow = torch.cat([torch.arange(e, device=dev),
                          torch.full((n,), e, device=dev)])
        order = torch.argsort(dst, stable=True)
        indptr = torch.zeros(n + 1, dtype=torch.long, device=dev)
        torch.cumsum(torch.bincount(dst, minlength=n), 0, out=indptr[1:])
        return EdgeCSR(n=n, n_real=e, indptr=indptr.int(),
                       src=src[order].int(), erow=erow[order].int())


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of ``scores`` (E, ...) over the entries of each segment, with
    the reference's guard (a segment max that is not finite counts as 0) and
    ``+1e-16`` in the denominator."""
    return _segment_softmax(scores, segment_ids, num_segments)[0]


def _segment_softmax(scores, segment_ids, num_segments):
    """:func:`segment_softmax` and the log-sum-exp of each segment, ``max +
    log(sum exp(s - max) + 1e-16)``, so that the softmax is ``exp(s -
    lse[segment])``."""
    shape = (num_segments,) + tuple(scores.shape[1:])
    idx = segment_ids.reshape((-1,) + (1,) * (scores.dim() - 1)).expand_as(
        scores)
    seg_max = torch.full(shape, -torch.inf, dtype=scores.dtype,
                         device=scores.device).scatter_reduce_(
        0, idx, scores, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(scores - seg_max[segment_ids])
    seg_sum = torch.zeros(shape, dtype=scores.dtype,
                          device=scores.device).index_add_(0, segment_ids, ex)
    return (ex / (seg_sum[segment_ids] + 1e-16),
            seg_max + torch.log(seg_sum + 1e-16))


def _gatv2_messages(g: EdgeCSR, w_src, w_dst, we, we_loop, att):
    """Per slot and head: the gathered source rows (E', H, C), the messages
    before the LeakyReLU and the scores (E', H)."""
    heads, ch = att.shape
    xs = w_src[g.src.long()].view(-1, heads, ch)
    we_all = torch.cat([we, we_loop[None]])[g.erow.long()]
    msg = xs + w_dst[g.dst_ids].view(-1, heads, ch) + we_all.view(
        -1, heads, ch)
    act = torch.where(msg >= 0, msg, LEAKY_SLOPE * msg)
    return xs, msg, torch.sum(act * att, dim=-1)


def _gatv2_plain(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep=None):
    """Plain version of K9 -> (out (n, H C), lse (n, H))."""
    heads, ch = att.shape
    xs, _, scores = _gatv2_messages(g, w_src, w_dst, we, we_loop, att)
    alpha, lse = _segment_softmax(scores, g.dst_ids, g.n)
    if keep is not None:
        alpha = alpha * keep
    out = torch.zeros((g.n, heads * ch), dtype=w_src.dtype,
                      device=w_src.device).index_add_(
        0, g.dst_ids, (xs * alpha[..., None]).reshape(-1, heads * ch))
    return out, lse


def gatv2_softmax_agg_plain(g: EdgeCSR, w_src, w_dst, we, we_loop, att,
                            keep=None):
    """Plain version of K9."""
    return _gatv2_plain(g, w_src, w_dst, we, we_loop, att, keep)[0]


def gatv2_softmax_agg_bwd_plain(g: EdgeCSR, w_src, w_dst, we, we_loop, att,
                                keep, lse, out, dout):
    """Plain version of K11: explicit formulas of K9's VJP, with the
    LeakyReLU's derivative 1 at 0 as ``jnp.where(x >= 0, ...)`` has it."""
    heads, ch = att.shape
    hc = heads * ch
    dst = g.dst_ids
    xs, msg, scores = _gatv2_messages(g, w_src, w_dst, we, we_loop, att)
    alpha = torch.exp(scores - lse[dst])                       # (E', H)
    kp = torch.ones_like(alpha) if keep is None else keep
    go = dout.view(-1, heads, ch)
    dalpha = kp * torch.sum(go[dst] * xs, dim=-1)
    dd = torch.sum(go * out.view(-1, heads, ch), dim=-1)       # (n, H)
    ds = alpha * (dalpha - dd[dst])
    act = torch.where(msg >= 0, msg, LEAKY_SLOPE * msg)
    dmsg = (ds[..., None] * att * torch.where(msg >= 0, 1.0, LEAKY_SLOPE)
            ).reshape(-1, hc)
    d_att = torch.sum(ds[..., None] * act, dim=0)
    zeros = torch.zeros((g.n, hc), dtype=w_src.dtype, device=w_src.device)
    d_w_dst = zeros.clone().index_add_(0, dst, dmsg)
    d_w_src = zeros.index_add_(
        0, g.src.long(),
        ((alpha * kp)[..., None] * go[dst]).reshape(-1, hc) + dmsg)
    erow = g.erow.long()
    real = erow < g.n_real
    d_we = torch.zeros_like(we).index_add_(0, erow[real], dmsg[real])
    return d_w_src, d_w_dst, d_we, torch.sum(dmsg[~real], dim=0), d_att


def gatv2_lanes(heads: int, ch: int) -> Tuple[int, int]:
    """K9 / K11's lane layout for ``heads`` x ``ch``: ``(lanes per head,
    channels per lane)``.  The heads split a warp's 32 lanes into groups of
    32 / (heads rounded up to a power of two) lanes and a lane holds at most
    8 channels, so heads * channels <= 256 for a power-of-two head count.
    Raises ValueError for a width past that limit."""
    hp = 1 << max(0, int(heads) - 1).bit_length()
    if heads >= 1 and ch >= 1 and hp <= 32:
        lph = 32 // hp
        per_lane = -(-int(ch) // lph)
        if per_lane <= K9_MAX_PER_LANE:
            return lph, per_lane
    raise ValueError(
        f"K9 / K11 take heads * channels <= {K9_MAX_WIDTH}: at most 32 heads "
        f"and {K9_MAX_PER_LANE} channels per lane, 32 / (heads rounded up to "
        f"a power of two) lanes per head; got {heads} heads x {ch} channels")


def _check_gatv2(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep, dev):
    heads, ch = att.shape
    gatv2_lanes(heads, ch)
    hc = heads * ch
    _check(w_src, "w_src", torch.float32, (g.n, hc), dev)
    _check(w_dst, "w_dst", torch.float32, (g.n, hc), dev)
    _check(we, "we", torch.float32, (g.n_real, hc), dev)
    _check(we_loop, "we_loop", torch.float32, (hc,), dev)
    _check(att, "att", torch.float32, (heads, ch), dev)
    _check(g.indptr, "indptr", torch.int32, (g.n + 1,), dev)
    _check(g.src, "src", torch.int32, (g.n_slots,), dev)
    _check(g.erow, "erow", torch.int32, (g.n_slots,), dev)
    if keep is not None:
        _check(keep, "keep", torch.float32, (g.n_slots, heads), dev)
    _i32(max(g.n, g.n_slots) * hc, "slots * channels")


def _gatv2_forward(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep,
                   with_lse: bool):
    """K9 or, for CPU tensors, its plain version -> (out, lse or None)."""
    k = KERNELS["gatv2_softmax_agg"]
    if _is_cpu(w_src):
        k.plain_calls += 1
        out, lse = _gatv2_plain(g, w_src, w_dst, we, we_loop, att, keep)
        return out, lse if with_lse else None
    dev = w_src.device
    _check_gatv2(g, w_src, w_dst, we, we_loop, att, keep, dev)
    heads, ch = att.shape
    out = torch.empty((g.n, heads * ch), dtype=torch.float32, device=dev)
    lse = (torch.empty((g.n, heads), dtype=torch.float32, device=dev)
           if with_lse else None)
    k.launch(g.indptr.data_ptr(), g.src.data_ptr(), g.erow.data_ptr(),
             w_src.data_ptr(), w_dst.data_ptr(),
             we.data_ptr() if g.n_real else None,
             we_loop.data_ptr(), att.data_ptr(), _ptr(keep), g.n, g.n_real,
             heads, ch, LEAKY_SLOPE, out.data_ptr(), _ptr(lse), _stream(dev))
    return out, lse


def gatv2_softmax_agg_bwd(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep,
                          lse, out, dout):
    """K11: the gradients ``(d_w_src, d_w_dst, d_we, d_we_loop, d_att)`` of
    K9's inputs from ``dout`` (n, heads * ch), the gradient of its output,
    given K9's ``lse`` and ``out`` for the same inputs (and ``keep``)."""
    k = KERNELS["gatv2_softmax_agg_bwd"]
    if _is_cpu(dout):
        k.plain_calls += 1
        return gatv2_softmax_agg_bwd_plain(g, w_src, w_dst, we, we_loop, att,
                                           keep, lse, out, dout)
    dev = dout.device
    _check_gatv2(g, w_src, w_dst, we, we_loop, att, keep, dev)
    heads, ch = att.shape
    hc = heads * ch
    _check(lse, "lse", torch.float32, (g.n, heads), dev)
    _check(out, "out", torch.float32, (g.n, hc), dev)
    _check(dout, "dout", torch.float32, (g.n, hc), dev)
    src_ptr, src_slot = g.by_src

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    d_w_src, d_w_dst, d_we = empty(g.n, hc), empty(g.n, hc), empty(
        g.n_real, hc)
    d_we_loop, d_att = empty(hc), empty(heads, ch)
    buf = empty(g.n_slots, hc)
    part = empty(K11_MAX_PARTS, 2 * hc, dtype=torch.float64)
    k.launch(g.indptr.data_ptr(), g.src.data_ptr(), g.erow.data_ptr(),
             src_ptr.data_ptr(), src_slot.data_ptr(), w_src.data_ptr(),
             w_dst.data_ptr(), we.data_ptr() if g.n_real else None,
             we_loop.data_ptr(), att.data_ptr(), _ptr(keep), lse.data_ptr(),
             out.data_ptr(), dout.data_ptr(), g.n, g.n_real, heads, ch,
             LEAKY_SLOPE,
             d_w_src.data_ptr(), d_w_dst.data_ptr(),
             d_we.data_ptr() if g.n_real else None, d_we_loop.data_ptr(),
             d_att.data_ptr(), buf.data_ptr(), part.data_ptr(), _stream(dev))
    return d_w_src, d_w_dst, d_we, d_we_loop, d_att


class _GATv2SoftmaxAgg(torch.autograd.Function):
    """K9 forward (with its lse), K11 backward; their plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, g, keep, w_src, w_dst, we, we_loop, att):
        out, lse = _gatv2_forward(g, w_src, w_dst, we, we_loop, att, keep,
                                  True)
        ctx.g = g
        ctx.save_for_backward(w_src, w_dst, we, we_loop, att, keep, lse, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        w_src, w_dst, we, we_loop, att, keep, lse, out = ctx.saved_tensors
        return (None, None) + gatv2_softmax_agg_bwd(
            ctx.g, w_src, w_dst, we, we_loop, att, keep, lse, out,
            dout.contiguous())


def gatv2_softmax_agg(g: EdgeCSR, w_src: torch.Tensor, w_dst: torch.Tensor,
                      we: torch.Tensor, we_loop: torch.Tensor,
                      att: torch.Tensor,
                      keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: per destination node and head, the LeakyReLU-att scores of its
    incoming edges, their softmax and the alpha-weighted sum of the source
    rows -> (n, heads * ch).  ``w_src``, ``w_dst`` (n, heads * ch) are the
    projected nodes, ``we`` (n_real, heads * ch) the projected edge features,
    ``we_loop`` (heads * ch,) the self-loops' shared row, ``att`` (heads,
    ch), ``keep`` (n_real + n, heads) an optional dropout keep-scale on alpha
    in the CSR's slot order.  The kernel takes heads * ch <= 256 (see
    :func:`gatv2_lanes`).  When an input requires a gradient, the call is an
    autograd node whose backward is K11."""
    tensors = (w_src, w_dst, we, we_loop, att)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _GATv2SoftmaxAgg.apply(g, keep, *tensors)
    return _gatv2_forward(g, *tensors, keep, False)[0]


# --------------------------------------------------------------------------- #
# K10: mean / max / attention pooling per graph, K12: its backward (float32)
# --------------------------------------------------------------------------- #

K10_CHUNK = 256          # nodes per block of the first pass
K10_MAX_D = 256          # kMaxD in graph_pool.cu and graph_pool_bwd.cu


@dataclasses.dataclass
class GraphSegments:
    """The graphs of a batch as contiguous node ranges ``ptr[b]:ptr[b+1]``,
    each cut on the host into chunks of at most ``K10_CHUNK`` nodes
    (``chunk_start`` / ``chunk_end``; graph b owns chunks
    ``chunk_ptr[b]:chunk_ptr[b+1]``, none when it is empty, and
    ``chunk_graph`` names the graph of each chunk)."""

    num_graphs: int
    n_nodes: int
    ptr: torch.Tensor          # (B+1,) int32
    chunk_ptr: torch.Tensor    # (B+1,) int32
    chunk_start: torch.Tensor  # (n_chunks,) int32
    chunk_end: torch.Tensor    # (n_chunks,) int32
    chunk_graph: torch.Tensor  # (n_chunks,) int32

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_start.numel())

    @functools.cached_property
    def batch_ids(self) -> torch.Tensor:
        """(N,) int64 graph of each node (plain version only)."""
        return _ids_from_ptr(self.ptr)

    @staticmethod
    def from_counts(counts, device) -> "GraphSegments":
        counts = np.asarray(counts, np.int64)
        ptr = np.zeros(counts.size + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        _i32(ptr[-1] + 1, "nodes")
        per = -(-counts // K10_CHUNK)
        chunk_ptr = np.zeros(counts.size + 1, np.int64)
        np.cumsum(per, out=chunk_ptr[1:])
        which = np.repeat(np.arange(counts.size), per)
        start = ptr[:-1][which] + (np.arange(chunk_ptr[-1])
                                   - chunk_ptr[:-1][which]) * K10_CHUNK
        end = np.minimum(start + K10_CHUNK, ptr[1:][which])

        def t(a):
            return torch.tensor(a, dtype=torch.int32, device=device)

        return GraphSegments(num_graphs=int(counts.size),
                             n_nodes=int(ptr[-1]), ptr=t(ptr),
                             chunk_ptr=t(chunk_ptr), chunk_start=t(start),
                             chunk_end=t(end), chunk_graph=t(which))

    @staticmethod
    def from_batch(batch: torch.Tensor, num_graphs: int) -> "GraphSegments":
        """From the (N,) graph id of every node, which must be sorted."""
        ids = batch.detach().cpu().numpy()
        if ids.size and (np.any(np.diff(ids) < 0) or ids[0] < 0
                         or ids[-1] >= num_graphs):
            raise ValueError("graph ids must be sorted and in [0, num_graphs)")
        return GraphSegments.from_counts(
            np.bincount(ids, minlength=num_graphs), batch.device)


def _graph_pool_plain(seg: GraphSegments, x, score, keep=None):
    """Plain version of K10 -> (out (B, 3 d), stats (B, 2), ties (B, d))."""
    B, d = seg.num_graphs, x.shape[1]
    batch = seg.batch_ids
    zeros = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    counts = torch.zeros(B, dtype=x.dtype, device=x.device).index_add_(
        0, batch, torch.ones_like(score))
    x_mean = zeros.clone().index_add_(0, batch, x) / torch.clamp(
        counts, min=1.0)[:, None]
    x_max = torch.full((B, d), -torch.inf, dtype=x.dtype,
                       device=x.device).scatter_reduce_(
        0, batch[:, None].expand_as(x), x, "amax")
    ties = zeros.clone().index_add_(0, batch, (x == x_max[batch]).to(x.dtype))
    x_max = torch.where(torch.isfinite(x_max), x_max, 0.0)
    w = segment_softmax(score, batch, B)
    if keep is not None:
        w = w * keep
    x_attn = zeros.index_add_(0, batch, w[:, None] * x)
    # the softmax's (mu, l): w = exp(score - mu) / (l + 1e-16)
    mu = torch.full_like(counts, -torch.inf).scatter_reduce_(
        0, batch, score, "amax")
    mu = torch.where(torch.isfinite(mu), mu, 0.0)
    l_sum = torch.zeros_like(counts).index_add_(0, batch,
                                                torch.exp(score - mu[batch]))
    return (torch.cat([x_mean, x_max, x_attn], dim=-1),
            torch.stack([mu, l_sum], dim=1), ties)


def graph_pool_plain(seg: GraphSegments, x, score, keep=None):
    """Plain version of K10."""
    return _graph_pool_plain(seg, x, score, keep)[0]


def graph_pool_bwd_plain(seg: GraphSegments, x, score, keep, out, stats,
                         ties, dout):
    """Plain version of K12: explicit formulas of K10's VJP (the max's
    gradient split equally among tied nodes, as ``jax.ops.segment_max``'s
    is)."""
    d = x.shape[1]
    batch = seg.batch_ids
    counts = (seg.ptr[1:] - seg.ptr[:-1]).to(x.dtype)
    dmean = dout[:, :d] / torch.clamp(counts, min=1.0)[:, None]
    dmax = dout[:, d:2 * d] / torch.clamp(ties, min=1.0)
    dattn = dout[:, 2 * d:]
    w = torch.exp(score - stats[batch, 0]) / (stats[batch, 1] + 1e-16)
    kw = w if keep is None else keep * w
    a = torch.sum(x * dattn[batch], dim=1)
    dot = torch.sum(dattn * out[:, 2 * d:], dim=1)
    dx = (dmean[batch]
          + torch.where(x == out[batch, d:2 * d], dmax[batch], 0.0)
          + kw[:, None] * dattn[batch])
    dscore = w * ((a if keep is None else keep * a) - dot[batch])
    return dx, dscore


def _check_pool(seg: GraphSegments, x, score, keep, dev):
    if x.dim() != 2 or not 1 <= x.shape[1] <= K10_MAX_D:
        raise ValueError(f"x must be (N, d) with d <= {K10_MAX_D}, got "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    B, nc = seg.num_graphs, seg.n_chunks
    if n != seg.n_nodes:
        raise ValueError(f"the graphs have {seg.n_nodes} nodes, x has {n}")
    _check(x, "x", torch.float32, (n, d), dev)
    _check(score, "score", torch.float32, (n,), dev)
    if keep is not None:
        _check(keep, "keep", torch.float32, (n,), dev)
    _check(seg.ptr, "ptr", torch.int32, (B + 1,), dev)
    _check(seg.chunk_ptr, "chunk_ptr", torch.int32, (B + 1,), dev)
    _check(seg.chunk_start, "chunk_start", torch.int32, (nc,), dev)
    _check(seg.chunk_end, "chunk_end", torch.int32, (nc,), dev)
    _check(seg.chunk_graph, "chunk_graph", torch.int32, (nc,), dev)
    _i32(n * d, "N * d")


def _graph_pool_forward(seg: GraphSegments, x, score, keep, train: bool):
    """K10 or, for CPU tensors, its plain version -> (out, stats, ties), the
    last two only with ``train``."""
    k = KERNELS["graph_pool"]
    if _is_cpu(x):
        k.plain_calls += 1
        out, stats, ties = _graph_pool_plain(seg, x, score, keep)
        return (out, stats, ties) if train else (out, None, None)
    dev = x.device
    _check_pool(seg, x, score, keep, dev)
    n, d = x.shape
    B, nc = seg.num_graphs, seg.n_chunks
    part = torch.empty((max(nc, 1), 2 + 4 * d), dtype=torch.float32,
                       device=dev)
    out = torch.empty((B, 3 * d), dtype=torch.float32, device=dev)
    stats = ties = None
    if train:
        stats = torch.empty((B, 2), dtype=torch.float32, device=dev)
        ties = torch.empty((B, d), dtype=torch.float32, device=dev)
    k.launch(seg.ptr.data_ptr(), seg.chunk_ptr.data_ptr(),
             _ptr(seg.chunk_start) if nc else None,
             _ptr(seg.chunk_end) if nc else None, x.data_ptr(),
             score.data_ptr(), _ptr(keep), B, nc, d, part.data_ptr(),
             out.data_ptr(), _ptr(stats), _ptr(ties), _stream(dev))
    return out, stats, ties


def graph_pool_bwd(seg: GraphSegments, x, score, keep, out, stats, ties,
                   dout):
    """K12: the gradients ``(dx (N, d), dscore (N,))`` of K10's inputs from
    ``dout`` (B, 3 d), given K10's ``out``, ``stats`` and ``ties`` for the
    same inputs (and ``keep``)."""
    k = KERNELS["graph_pool_bwd"]
    if _is_cpu(dout):
        k.plain_calls += 1
        return graph_pool_bwd_plain(seg, x, score, keep, out, stats, ties,
                                    dout)
    dev = dout.device
    _check_pool(seg, x, score, keep, dev)
    n, d = x.shape
    B, nc = seg.num_graphs, seg.n_chunks
    _check(out, "out", torch.float32, (B, 3 * d), dev)
    _check(stats, "stats", torch.float32, (B, 2), dev)
    _check(ties, "ties", torch.float32, (B, d), dev)
    _check(dout, "dout", torch.float32, (B, 3 * d), dev)
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    dscore = torch.empty(n, dtype=torch.float32, device=dev)
    k.launch(seg.ptr.data_ptr(), _ptr(seg.chunk_start) if nc else None,
             _ptr(seg.chunk_end) if nc else None,
             _ptr(seg.chunk_graph) if nc else None, x.data_ptr(),
             score.data_ptr(), _ptr(keep), out.data_ptr(), stats.data_ptr(),
             ties.data_ptr(), dout.data_ptr(), nc, d,
             dx.data_ptr() if n else None, dscore.data_ptr() if n else None,
             _stream(dev))
    return dx, dscore


class _GraphPool(torch.autograd.Function):
    """K10 forward (with its stats and tie counts), K12 backward; their
    plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, seg, keep, x, score):
        out, stats, ties = _graph_pool_forward(seg, x, score, keep, True)
        ctx.seg = seg
        ctx.save_for_backward(x, score, keep, out, stats, ties)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        x, score, keep, out, stats, ties = ctx.saved_tensors
        return (None, None) + graph_pool_bwd(
            ctx.seg, x, score, keep, out, stats, ties, dout.contiguous())


def graph_pool(seg: GraphSegments, x: torch.Tensor, score: torch.Tensor,
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10: per graph, ``[mean x | max x | softmax(score)-weighted sum of
    x]`` -> (B, 3 d), from x (N, d) with d <= 256, the attention scores (N,)
    and an optional dropout keep-scale (N,) on the attention weights.  When
    an input requires a gradient, the call is an autograd node whose
    backward is K12."""
    if torch.is_grad_enabled() and (x.requires_grad or score.requires_grad):
        return _GraphPool.apply(seg, keep, x, score)
    return _graph_pool_forward(seg, x, score, keep, False)[0]


# --------------------------------------------------------------------------- #
# K13: the column sum of index-gathered rows (float32)
# --------------------------------------------------------------------------- #

K13_MAX_R = 256          # kMaxR in gather_rowsum.cu: 8 columns per lane
K13_MIN_TILE = 256       # indices per block at least
K13_MAX_BLOCKS = 8 * 132  # 8 blocks per SM of the H100


def gather_rowsum_grid(M: int) -> Tuple[int, int]:
    """(blocks, indices per block) of K13's first launch: tiles of at least
    ``K13_MIN_TILE`` indices, at most ``K13_MAX_BLOCKS`` blocks, none
    empty (one block for M = 0, which writes zeros)."""
    tile = max(K13_MIN_TILE, -(-M // K13_MAX_BLOCKS))
    return max(1, -(-M // tile)), tile


def gather_rowsum_plain(Y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: ``Y[idx].sum(0, keepdim=True)``."""
    return Y.index_select(0, idx).sum(0, keepdim=True)


def gather_rowsum(Y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K13: ``out (1, R) = sum_i Y[idx[i], :]`` for float32 Y (N, R), R <=
    256, and int32 indices in [0, N) (not checked on the card), summed in
    float32 in a fixed order: the same bits on every call."""
    k = KERNELS["gather_rowsum"]
    if _is_cpu(Y):
        k.plain_calls += 1
        return gather_rowsum_plain(Y, idx)
    dev = Y.device
    if Y.dim() != 2:
        raise ValueError(f"Y must be (N, R), got {tuple(Y.shape)}")
    N, R = Y.shape
    if not 1 <= R <= K13_MAX_R or N < 1:
        raise ValueError(f"gather_rowsum takes 1 <= R <= {K13_MAX_R} columns "
                         f"and N >= 1 rows, got {tuple(Y.shape)}")
    M = int(idx.numel())
    _check(Y, "Y", torch.float32, (N, R), dev)
    _check(idx, "idx", torch.int32, (M,), dev)
    _i32(N * R, "N * R")
    _i32(M, "M")
    n_blocks, tile = gather_rowsum_grid(M)
    part = torch.empty((n_blocks, R), dtype=torch.float32, device=dev)
    out = torch.empty((1, R), dtype=torch.float32, device=dev)
    k.launch(Y.data_ptr(), idx.data_ptr(), N, M, R, tile, n_blocks,
             part.data_ptr(), out.data_ptr(), _stream(dev))
    return out
