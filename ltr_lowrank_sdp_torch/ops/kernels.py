"""The port's sixteen CUDA kernels, their plain PyTorch versions, and the build.

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

and in :data:`LOOP_KERNELS` (counted by :func:`loop_counts`), the body of
HALLaR's inner FISTA loop (``hallar/solver.py``, replacing
``ltr_lowrank_sdp_tpu/hallar/solver.py`` ``_make_fista`` / ``_make_aipp``,
which XLA compiles into a few fusions inside one ``lax.while_loop``):

=====  ====================  ==============================================
K14    fista_candidate       the projected candidate, the extrapolated
                             point and their sums (:221-247, :198-202,
                             the prox body :291-318): one thread-block
                             cluster, or two launches past
                             K14_CLUSTER_MAX_N (:func:`k14_plan`)
K15    al_value              the AL (or prox) value of A(YY^T) and <C,
                             YY^T>, and K6's weights (:208-214, :277-284):
                             at one point, or both points of a machine
                             step in one launch (:func:`al_value_pair`)
K16    fista_commit          the backtracking decision and the FISTA
                             update, in place (:231-232, :239-247)
=====  ====================  ==============================================

K1-K4 carry the MaxCut family (one diagonal constraint per row); K5 and K6
carry every other SDP cone (sparse or dense constraint kind), with K1 and K4
for a sparse objective and ``torch.matmul`` for a dense one; K7 and K8 carry
the LP cone.  K1-K8 are templates on the value type: float64, or float32 for
the solver's ``dtype="float32"`` (K4 then still forms its products and sums
in float64; HALLaR's float32 objective sums in float32).  K9 and K10 carry
the rank-schedule predictor's graph encoder at any width (:func:`k9_plan`,
:func:`k11_groups`, ``K10_MAX_D``),
and K11 and K12 its training backward pass: K9 + K11 and K10 + K12 are each
one ``torch.autograd.Function`` (:func:`gatv2_softmax_agg`, :func:`graph_pool`
when an input requires a gradient), with a plain backward beside the plain
forward for the CPU.  One more source, ``csrc/launch_floor.cu``, holds an
empty kernel built and bound the same way (:func:`launch_floor`): its time on
the card is the floor of any launch's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
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
    folds: int = 0          # launches that formed their row scale inside
                            # (K1's d * w; each saves an elementwise launch)
    lib_path: Optional[pathlib.Path] = None
    build_log: str = ""
    _lib: Optional[ctypes.CDLL] = None
    _fn: Optional[object] = None
    _resident: Dict[Tuple, int] = dataclasses.field(default_factory=dict)

    @property
    def source(self) -> pathlib.Path:
        return CSRC_DIR / f"{self.name}.cu"

    @property
    def symbol(self) -> str:
        return f"ltr_{self.name}"

    def fn(self):
        if self._fn is None:
            build_kernels()
            self._lib = ctypes.CDLL(str(self.lib_path))
            f = getattr(self._lib, self.symbol)
            f.argtypes = list(self.argtypes)
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def resident(self, device: torch.device, *instance: int) -> int:
        """The blocks of the instantiation named by ``instance`` that fit
        one SM of ``device`` (the current device) at once: CUDA's occupancy
        query, through the source's ``ltr_<name>_resident``, once per device
        and instantiation.  K4 and K11 size their grids from it."""
        key = (device.index, instance)
        if key not in self._resident:
            self.fn()
            blocks = ctypes.c_int(0)
            err = getattr(self._lib, f"{self.symbol}_resident")(
                *(ctypes.c_int(int(v)) for v in instance),
                ctypes.byref(blocks))
            if err != 0 or blocks.value < 1:
                raise RuntimeError(f"occupancy of {self.name} {instance}: "
                                   f"cudaError {err}, {blocks.value} blocks")
            self._resident[key] = blocks.value
        return self._resident[key]

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
           (_I,) + (_P,) * 8 + (_I, _I, _D, _I, _I, _I, _I, _I, _P),
           typed=True),
    Kernel("diag_rowdot",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:231",
           (_I, _P, _P, _P, _D, _P, _P, _I, _I, _I, _I, _I, _P), typed=True),
    Kernel("diag_normal_matvec",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:272",
           (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), typed=True),
    Kernel("sym_contract_sum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:332",
           (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
           typed=True),
    Kernel("coo_contract_segsum",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:143",
           (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P,
            _I, _P, _P, _I, _P, _P, _I, _I, _I, _P), typed=True),
    Kernel("spmm_constr_csr",
           "ltr_lowrank_sdp_tpu/ops/gatherseg.py:256",
           (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _I, _I, _I, _P),
           typed=True),
    Kernel("lp_constr_segsum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:435",
           (_I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P), typed=True),
    Kernel("lp_col_wsum",
           "ltr_lowrank_sdp_tpu/ops/coneops.py:443",
           (_I,) + (_P,) * 9 + (_D, _I, _I, _I, _I, _P, _P), typed=True),
    Kernel("gatv2_softmax_agg",
           "ltr_lowrank_sdp_tpu/models/gatv2.py:26",
           (_P,) * 9 + (_I,) * 11 + (_F, _P, _P, _P, _P)),
    Kernel("graph_pool",
           "ltr_lowrank_sdp_tpu/models/layers.py:93",
           (_P,) * 6 + (_I,) + (_P,) * 3 + (_I,) * 7 + (_P,) * 6),
    Kernel("gatv2_softmax_agg_bwd",
           "ltr_lowrank_sdp_tpu/models/gatv2.py:26 (VJP, train.py:250)",
           (_P,) * 16 + (_I,) * 6 + (_F, _I, _I, _I) + (_P,) * 9),
    Kernel("graph_pool_bwd",
           "ltr_lowrank_sdp_tpu/models/layers.py:93 (VJP, train.py:250)",
           (_P,) * 12 + (_I,) * 7 + (_P,) * 7),
    Kernel("gather_rowsum",
           "scripts/pallas_gather_probe.py:41",
           (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P)),
)}


# an empty kernel for the launch floor (csrc/launch_floor.cu): built with the
# kernels, counted by no path
LAUNCH_FLOOR = Kernel("launch_floor", "none", (_P,))
# the conditional graph nodes of the solver's device-resident loops
# (csrc/graph_cond.cu, bound in solver/devloop.py): built with the kernels;
# its symbol reports the CUDA runtime's version
GRAPH_COND = Kernel("graph_cond", "none", (ctypes.POINTER(_I),))


def reset_counts() -> None:
    for k in (*KERNELS.values(), *LOOP_KERNELS.values()):
        k.launches = 0
        k.launches_f32 = 0
        k.plain_calls = 0
        k.folds = 0


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
    for k in (*KERNELS.values(), *LOOP_KERNELS.values(), LAUNCH_FLOOR,
              GRAPH_COND):
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


def launch_floor(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream, through the
    ctypes path every kernel takes: timed, its launch is the floor of any
    kernel's time on the card."""
    LAUNCH_FLOOR.launch(_stream(device))


def ptxas_usage(name: str) -> Dict[Tuple, Tuple[int, int, int]]:
    """``{(kind, value type, template ints): (registers, spill store bytes,
    spill load bytes)}`` of each ``__global__`` instantiation of one
    kernel's source, read from ``-Xptxas -v`` in this process's build log
    (empty when the library was already built).  ``kind`` is ``"main"``,
    K5's second launch ``"long_reduce"``, K11's two passes ``"dst"`` and
    ``"src"``, K13's ``"hist"`` and ``"pass"`` (the counts plan) and
    ``"tiles"`` (the gather), K14's ``"cluster"``, ``"norm"`` and
    ``"step"`` (its cluster plan, its two-launch plan's launches); the value type ``"f64"``, ``"f32"`` or
    ``"-"`` (a float32 kernel with no value template); the ints the
    template's int and bool arguments in order, e.g. ``(32, 5)`` for K6's G
    = 32, CPL = 5, ``(2, 16, 2, 2)`` for K5's pair mode at G = 16, CPL = 2,
    KC = 2 and ``(1, 8, 1)`` for K4's U-is-V at G = 8, CPL = 1."""
    out: Dict[Tuple, Tuple[int, int, int]] = {}
    key, spill = None, (0, 0)
    for line in {**KERNELS, **LOOP_KERNELS}[name].build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            t = re.search(r"_kernelI((?:L[ib]\d+E|[df])+)E", fn)
            kind = next((k for k in ("long_reduce", "dst", "src", "hist",
                                     "pass", "tiles", "cluster", "norm",
                                     "step")
                         if f"{k}_kernel" in fn), "main")
            types = "" if t is None else re.sub(r"L[ib]\d+E", "", t.group(1))
            key = None if t is None else (
                kind, {"f": "f32", "d": "f64"}.get(types, "-"),
                tuple(int(x) for x in re.findall(r"L[ib](\d+)E",
                                                 t.group(1))))
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            out[key] = (int(m.group(1)), *spill)
            key = None
    return out


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
    diagonal once), built on the host from its upper-triangle COO, with the
    order in which K1's warps take the rows: the reverse Cuthill-McKee
    order of its graph (None for a diagonal matrix), so the rows of one
    block are near one another and gather many of the same rows of Y (L1
    hits); a row's own sum does not depend on it.  Plans of fewer than
    ``K1_ORDER_MIN_G`` lanes a row keep the file order: with 16 or 32 rows
    a warp the rows' own loads and stores coalesce only there."""

    n: int
    indptr: torch.Tensor     # (n+1,) int32
    indices: torch.Tensor    # (nnz,) int32
    vals: torch.Tensor       # (nnz,) float64 or float32
    order: Optional[torch.Tensor]   # (n,) int32, None: 0 .. n-1

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
        order = None
        if (r_all != c_all).any():
            order = torch.tensor(
                scipy.sparse.csgraph.reverse_cuthill_mckee(
                    scipy.sparse.csr_matrix(
                        (np.ones(c_all.size, np.int8), c_all, indptr),
                        shape=(n, n)), symmetric_mode=True).copy(),
                dtype=torch.int32, device=device)
        return SymCSR(
            n=n,
            indptr=torch.tensor(indptr, dtype=torch.int32, device=device),
            indices=torch.tensor(c_all, dtype=torch.int32, device=device),
            vals=torch.tensor(v_all, dtype=dtype, device=device),
            order=order)


def spmm_sym_csr_plain(csr: Optional[SymCSR], Y: torch.Tensor,
                       alpha: float = 1.0,
                       d: Optional[torch.Tensor] = None,
                       w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K1: ``alpha * C @ Y + d[:, None] * Y``, the row
    scale ``d * w`` when ``w`` is given.  Y may hold rows past C's (a row
    shard's halo, :mod:`..parallel.rowshard`): the output has C's rows, and
    the row scale reads Y's first rows."""
    out = None
    n = Y.shape[0] if csr is None else csr.n
    if csr is not None:
        cy = Y.new_zeros((n,) + tuple(Y.shape[1:])).index_add_(
            0, csr.row_ids, csr.vals[:, None] * Y[csr.indices.long()])
        out = alpha * cy
    if d is not None:
        dy = (d if w is None else d * w)[:, None] * Y[:n]
        out = dy if out is None else out + dy
    return out


K1_NV = (1, 2, 4)        # vectors a lane and pass (instantiated in the .cu)
K1_STEPS = (2, 4, 8)     # entries whose gathers a lane has in flight
K1_MAX_IN_FLIGHT = 32    # kMaxInFlight: steps x NV x V at most
K1_STEP_BYTES = 64       # the planned step's gathered bytes a lane
K1_ORDER_MIN_G = 4       # lanes a row from which K1 takes rows in RCM order


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """K1's instantiation at one rank: ``v`` columns a vector load, ``g``
    lanes a row, ``nv`` vectors a lane and pass and ``s`` entries a step
    (their gathers all in flight before the step's first add).  Every
    output element adds its row's entries in CSR order whatever the plan,
    so every plan gives the same bits."""

    v: int
    g: int
    nv: int
    s: int

    def covers(self, r: int) -> bool:
        return r % self.v == 0 and (self.g == 32
                                    or r <= self.g * self.nv * self.v)

    def describe(self) -> str:
        return f"V={self.v} G={self.g} NV={self.nv} S={self.s}"


def _k1_widths(r: int, dtype: torch.dtype) -> List[int]:
    """The vector widths (columns a load, at most 16 bytes) that divide r,
    widest first."""
    widest = 4 if dtype == torch.float32 else 2
    return [v for v in (4, 2, 1) if v <= widest and r % v == 0]


def _k1_group(r: int, v: int, nv: int) -> int:
    g = 1
    while g < 32 and g * nv * v < r:
        g *= 2
    return g


def k1_plans(r: int, dtype: torch.dtype) -> List[K1Plan]:
    """Every K1 plan for rank ``r`` and value type ``dtype``: each vector
    width that divides r with each ``K1_NV``, the group the smallest power
    of two whose lanes cover r (at most 32, wider r in passes), and each of
    ``K1_STEPS`` whose gathers fit ``K1_MAX_IN_FLIGHT`` values; a (v, g)
    whose group a smaller ``nv`` already covers in one pass is left out."""
    if r < 1:
        raise ValueError(f"rank {r} < 1")
    out = []
    for v in _k1_widths(r, dtype):
        for nv in K1_NV:
            g = _k1_group(r, v, nv)
            if any(p.v == v and p.g == g and p.nv < nv and g < 32
                   for p in out):
                continue
            out.extend(K1Plan(v, g, nv, s) for s in K1_STEPS
                       if s * nv * v <= K1_MAX_IN_FLIGHT)
    return out


def k1_plan(r: int, dtype: torch.dtype, align: int = 16) -> K1Plan:
    """K1's plan at rank ``r``: the widest vector that divides r and that
    Y's address alignment ``align`` (bytes) allows, the fewest vectors a
    lane that leave a group of at most 8 lanes (4 rows or more a warp), and
    as many entries a step as keep a lane's gathers in flight within
    ``K1_STEP_BYTES`` (at least 2): the fastest plan, or within 13 % of
    it, at every shape ``chip_smoke.py``'s ``[k1-plan]`` times on the H100
    (``PERF.md``)."""
    if r < 1:
        raise ValueError(f"rank {r} < 1")
    size = 4 if dtype == torch.float32 else 8
    v = next(v for v in _k1_widths(r, dtype) if align % (v * size) == 0)
    nv = next((nv for nv in K1_NV if _k1_group(r, v, nv) <= 8), K1_NV[-1])
    s = max([K1_STEPS[0]] + [s for s in K1_STEPS
                             if s * nv * v * size <= K1_STEP_BYTES])
    return K1Plan(v, _k1_group(r, v, nv), nv, s)


def k1_cap(dev: torch.device, dtype: torch.dtype, plan: K1Plan) -> int:
    """The blocks of K1's instantiation that fit ``dev`` at once: its SMs
    times the occupancy query's blocks an SM."""
    return _sm_count(dev) * KERNELS["spmm_sym_csr"].resident(
        dev, _f32(dtype), plan.v, plan.g, plan.nv, plan.s)


def spmm_sym_csr(csr: Optional[SymCSR], Y: torch.Tensor, alpha: float = 1.0,
                 d: Optional[torch.Tensor] = None,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``alpha * C @ Y (+ d[:, None] * Y)`` for a static symmetric C;
    with ``w`` the row scale is ``d * w``, formed inside the kernel.

    ``csr=None`` applies only the diagonal term (``d`` is then required).
    Y may have more rows than C: a row shard's C (``parallel/rowshard.py``)
    numbers its columns into the shard's own rows, then its halo rows, which
    follow them in Y; the output has C's rows."""
    return spmm_sym_csr_with(None, csr, Y, alpha, d, w)


def spmm_sym_csr_with(plan: Optional[K1Plan], csr: Optional[SymCSR],
                      Y: torch.Tensor, alpha: float = 1.0,
                      d: Optional[torch.Tensor] = None,
                      w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`spmm_sym_csr` launched with ``plan`` (None: :func:`k1_plan`
    of the call).  Every plan gives the same bits; the tests and the smoke
    run hold each of :func:`k1_plans` to that."""
    k = KERNELS["spmm_sym_csr"]
    if csr is None and d is None:
        raise ValueError("spmm_sym_csr needs C, d, or both")
    if w is not None and d is None:
        raise ValueError("spmm_sym_csr: w scales d, which is missing")
    if _is_cpu(Y):
        k.plain_calls += 1
        return spmm_sym_csr_plain(csr, Y, alpha, d, w)
    dev = Y.device
    if Y.dim() != 2:
        raise ValueError(f"Y must be (n, r), got {tuple(Y.shape)}")
    n_y, r = Y.shape
    dt = _value_dtype(Y, "Y")
    _check(Y, "Y", dt, (n_y, r), dev)
    _i32(n_y * max(r, 1), "n * r")
    n = n_y
    if csr is not None:
        n = csr.n
        if n > n_y:
            raise ValueError(f"C has {n} rows, Y only {n_y}")
        _check(csr.indptr, "indptr", torch.int32, (n + 1,), dev)
        _check(csr.indices, "indices", torch.int32, (csr.nnz,), dev)
        _check(csr.vals, "vals", dt, (csr.nnz,), dev)
        if csr.order is not None:
            _check(csr.order, "order", torch.int32, (n,), dev)
    if d is not None:
        _check(d, "d", dt, (n,), dev)
    if w is not None:
        _check(w, "w", dt, (n,), dev)
    out = torch.empty((n, r), dtype=dt, device=dev)
    if n == 0 or r == 0:
        return out
    size = Y.element_size()
    if plan is None:
        plan = k1_plan(r, dt, Y.data_ptr() & -Y.data_ptr())
    elif not plan.covers(r) or Y.data_ptr() % (plan.v * size):
        raise ValueError(f"{plan.describe()} does not cover r = {r} at "
                         f"Y's address")
    k.launch(_f32(dt), _ptr(csr.indptr) if csr else None,
             _ptr(csr.indices) if csr else None,
             _ptr(csr.vals) if csr else None,
             _ptr(csr.order) if csr and plan.g >= K1_ORDER_MIN_G else None,
             Y.data_ptr(), _ptr(d), _ptr(w), out.data_ptr(), n, r,
             float(alpha), plan.v, plan.g, plan.nv, plan.s,
             k1_cap(dev, dt, plan),
             _stream(dev))
    if w is not None:
        k.folds += 1
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


K2_MAX_SLOTS = 8          # virtual lanes a lane of K2 holds at most
K2_PLAN_SLOTS = (4, 2)    # ... in the planned launch: one 32-column pass
                          # of a row, more than one


@dataclasses.dataclass(frozen=True)
class K2Plan:
    """K2's launch: ``lanes`` (G) lanes a row, each holding ``slots`` (J)
    of the 32 virtual lanes of K2's sum order (J a power of two, J G >=
    min(r, 32)).  Every plan gives the same bits."""

    lanes: int
    slots: int

    def describe(self) -> str:
        return f"G={self.lanes} J={self.slots}"


def _k2_slots(r: int, lanes: int) -> int:
    need = -(-min(max(r, 1), 32) // lanes)
    return min(_pow2(need), 32 // lanes)


def k2_plans(r: int, dtype: torch.dtype) -> List[K2Plan]:
    """The planned launch first, then every other instantiated group size
    (``csrc/diag_rowdot.cu``'s ``K2_CASE`` and, the same list,
    ``csrc/diag_normal_matvec.cu``'s ``K3_CASE``: at most ``K2_MAX_SLOTS``
    virtual lanes a lane)."""
    plans = [K2Plan(g, _k2_slots(r, g)) for g in (1, 2, 4, 8, 16, 32)]
    plans = [p for p in plans if p.slots <= K2_MAX_SLOTS]
    plan = k2_plan(r, dtype)
    return [plan] + [p for p in plans if p != plan]


def k2_plan(r: int, dtype: torch.dtype) -> K2Plan:
    """K2's and K3's lanes a row: the fewest (a power of two) that leave a
    lane at most ``K2_PLAN_SLOTS`` virtual lanes: 4 where a row is one pass
    of 32 columns, 2 where it takes more (K2: the fastest or within 3 % of
    it at every rank timed on the card; K3: within 4 % of the fastest at r
    <= 32 and of the one-warp-a-row kernel it replaced above, ``PERF.md``;
    the same in both value types)."""
    cap = K2_PLAN_SLOTS[0] if r <= 32 else K2_PLAN_SLOTS[1]
    g = 1
    while _k2_slots(r, g) > cap:
        g *= 2
    return K2Plan(g, _k2_slots(r, g))


def _group_cap(name: str, dev: torch.device, dtype: torch.dtype,
               plan: K2Plan, *wide: int) -> int:
    """The blocks of K2's or K3's ``plan`` (K3: and its instantiation for
    rows of more than 32 columns, ``wide``) that fit the card at once."""
    return _sm_count(dev) * KERNELS[name].resident(
        dev, _f32(dtype), plan.lanes, plan.slots, *wide)


def _round_bits(num: int, shift: int, mant: int) -> float:
    """``num * 2**shift`` rounded to ``mant`` significant bits, ties to
    even (``num`` != 0; no overflow or subnormal)."""
    m = abs(num)
    extra = m.bit_length() - mant
    if extra > 0:
        q, rem = m >> extra, m & ((1 << extra) - 1)
        half = 1 << (extra - 1)
        if rem > half or (rem == half and q & 1):
            q += 1
        m, shift = q, shift + extra
    v = math.ldexp(m, shift)
    return -v if num < 0 else v


def _fma_exact(a: float, b: float, c: float, mant: int) -> float:
    """``a * b + c`` rounded once to ``mant`` significant bits (53:
    float64's fused multiply-add, 24: float32's), from exact integers."""
    if not (math.isfinite(a) and math.isfinite(b) and math.isfinite(c)):
        return a * b + c
    (an, ad), (bn, bd), (cn, cd) = (a.as_integer_ratio(),
                                    b.as_integer_ratio(),
                                    c.as_integer_ratio())
    den = max(ad * bd, cd)          # powers of two
    num = an * bn * (den // (ad * bd)) + cn * (den // cd)
    if num == 0:     # -0 only where a * b and c are both -0
        neg = (math.copysign(1.0, a) * math.copysign(1.0, b) < 0
               and math.copysign(1.0, c) < 0 and (a == 0 or b == 0))
        return -0.0 if neg else 0.0
    return _round_bits(num, 1 - den.bit_length(), mant)


def _fma_chains(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """The 32 virtual lanes of every row, (n, 32): virtual lane l adds
    columns l, l + 32, ... of ``A * B`` from 0 by fused multiply-adds in A's
    value type, ``acc = fma(A, B, acc)``."""
    dt = A.dtype
    mant = 24 if dt == np.float32 else 53
    fma = np.frompyfunc(lambda a, b, c: _fma_exact(a, b, c, mant), 3, 1)
    acc = np.zeros((A.shape[0], 32), dt)
    for c in range(A.shape[1]):
        l = c % 32
        acc[:, l] = fma(A[:, c].astype(np.float64), B[:, c].astype(np.float64),
                        acc[:, l].astype(np.float64)).astype(dt)
    return acc


def k2_chains(U: np.ndarray, V: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """K2's 32 virtual lanes of every row, (n, 32) each of ``uv`` and
    ``vv``: virtual lane l adds columns l, l + 32, ... from 0 by fused
    multiply-adds in U's value type, ``uv = fma(U, V, uv)``, ``vv = fma(V,
    V, vv)``."""
    return _fma_chains(U, V), _fma_chains(V, V)


def _group_tree(v: np.ndarray, plan: K2Plan) -> np.ndarray:
    """The halving tree over the 32 virtual lanes ``v`` (n, 32) as ``plan``
    takes it: a lane's slots j and j + o / G added in registers for the
    offsets o >= G, skipping the slots past J, which hold 0; the group's
    last levels as shuffles (lane k adds lane k + o).  Returns virtual lane
    0, the row's dot (``v`` is summed in place)."""
    g, j_max = plan.lanes, plan.slots
    held = np.zeros(32, bool)        # the virtual lanes the lanes hold
    for k in range(g):
        held[[k + j * g for j in range(j_max)]] = True
    for o in (16, 8, 4, 2, 1):
        for l in range(o):
            if o >= g and not held[l + o]:
                continue             # a register slot past J: 0, skipped
            v[:, l] = v[:, l] + v[:, l + o]
    return v[:, 0]


def _host(*ts) -> List[np.ndarray]:
    return [np.asarray(torch.as_tensor(t).cpu()) for t in ts]


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.float32 if dt == np.float32 else torch.float64


def diag_rowdot_order(U, V, dv, s: float = 1.0, second: bool = False,
                      plan: Optional[K2Plan] = None):
    """K2's result, bit for bit, evaluated on the host in its order
    (:func:`k2_chains`, then the halving tree over the virtual lanes) and
    as ``plan`` (None: :func:`k2_plan`) takes it (:func:`_group_tree`).
    Tensors or arrays on the host; returns tensors."""
    U, V, dv = _host(U, V, dv)
    dt = U.dtype
    plan = plan or k2_plan(U.shape[1], _torch_dtype(dt))
    uv, vv = k2_chains(U, V)
    o1 = (dt.type(s) * dv) * _group_tree(uv, plan)
    out = torch.from_numpy(np.ascontiguousarray(o1))
    if not second:
        return out
    return out, torch.from_numpy(np.ascontiguousarray(
        dv * _group_tree(vv, plan)))


def diag_rowdot(U: torch.Tensor, V: torch.Tensor, dv: torch.Tensor,
                s: float = 1.0, second: bool = False):
    """K2: ``(s*dv) * rowsum(U*V)``, and with ``second`` also
    ``dv * rowsum(V*V)`` from the same pass."""
    return diag_rowdot_with(None, U, V, dv, s, second)


def diag_rowdot_with(plan: Optional[K2Plan], U: torch.Tensor,
                     V: torch.Tensor, dv: torch.Tensor, s: float = 1.0,
                     second: bool = False, grid: Optional[int] = None):
    """K2 launched with ``plan`` (None: :func:`k2_plan`) on ``grid`` blocks
    (None: the blocks its rows need, at most those that fit the card at
    once).  Every plan and grid gives the same bits."""
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
    if plan is None:
        plan = k2_plan(r, dt)
    elif plan not in k2_plans(r, dt):
        raise ValueError(f"{plan.describe()} is not a plan of r = {r}")
    if grid is None:
        grid = min(-(-n // (256 // plan.lanes)),
                   _group_cap("diag_rowdot", dev, dt, plan))
    o1 = torch.empty(n, dtype=dt, device=dev)
    o2 = torch.empty(n, dtype=dt, device=dev) if second else None
    k.launch(_f32(dt), U.data_ptr(), V.data_ptr(), dv.data_ptr(), float(s),
             o1.data_ptr(), _ptr(o2), n, r, plan.lanes, plan.slots,
             max(int(grid), 1), _stream(dev))
    return (o1, o2) if second else o1


# --------------------------------------------------------------------------- #
# K3: ADMM normal-equation matvec
# --------------------------------------------------------------------------- #


def diag_normal_matvec_plain(x, F, dv):
    """Plain version of K3."""
    w = dv * torch.sum(x * F, dim=-1)
    return x + (dv * w)[:, None] * F


def diag_normal_matvec_order(x, F, dv, plan: Optional[K2Plan] = None):
    """K3's result, bit for bit, evaluated on the host: K2's dot order on
    (x, F) (:func:`_fma_chains`, then :func:`_group_tree` as ``plan``, None:
    :func:`k2_plan`, takes it), ``coef = d * (d * dot)`` with each product
    rounded, and ``y = fma(coef, F, x)`` rounded once.  Exact fused
    multiply-adds, so slow: hold a few hundred rows to it.  Tensors or
    arrays on the host; returns a tensor."""
    x, F, dv = _host(x, F, dv)
    dt = x.dtype
    plan = plan or k2_plan(x.shape[1], _torch_dtype(dt))
    dot = _group_tree(_fma_chains(x, F), plan)
    coef = dv * (dv * dot)
    mant = 24 if dt == np.float32 else 53
    fma = np.frompyfunc(lambda a, b, c: _fma_exact(a, b, c, mant), 3, 1)
    y = fma(coef.astype(np.float64)[:, None], F.astype(np.float64),
            x.astype(np.float64)).astype(dt)
    return torch.from_numpy(np.ascontiguousarray(y))


def diag_normal_matvec(x: torch.Tensor, F: torch.Tensor,
                       dv: torch.Tensor) -> torch.Tensor:
    """K3: ``x + (dv^2 * rowsum(x*F))[:, None] * F`` in one pass."""
    return diag_normal_matvec_with(None, x, F, dv)


def diag_normal_matvec_with(plan: Optional[K2Plan], x: torch.Tensor,
                            F: torch.Tensor, dv: torch.Tensor,
                            grid: Optional[int] = None) -> torch.Tensor:
    """K3 launched with ``plan`` (K2's lane groups, None: :func:`k2_plan`)
    on ``grid`` blocks (None: the blocks its rows need, at most those that
    fit the card at once).  Every plan and grid gives the same bits."""
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
    if plan is None:
        plan = k2_plan(r, dt)
    elif plan not in k2_plans(r, dt):
        raise ValueError(f"{plan.describe()} is not a plan of r = {r}")
    if grid is None:
        grid = min(-(-n // (256 // plan.lanes)),
                   _group_cap("diag_normal_matvec", dev, dt, plan,
                              int(r > 32)))
    y = torch.empty((n, r), dtype=dt, device=dev)
    k.launch(_f32(dt), x.data_ptr(), F.data_ptr(), dv.data_ptr(),
             y.data_ptr(), n, r, plan.lanes, plan.slots, max(int(grid), 1),
             _stream(dev))
    return y


# --------------------------------------------------------------------------- #
# K4: <C, sym(U V^T)>
# --------------------------------------------------------------------------- #

K4_CHUNK = 256            # entries a chunk (kChunk in sym_contract_sum.cu)


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """K4's launch: ``g`` lanes an entry and ``cpl`` columns a lane (the sum
    order, from r), and ``grid`` blocks over the ``chunks`` chunks of
    ``K4_CHUNK`` entries.  ``grid`` never changes the bits."""

    g: int
    cpl: int
    chunks: int
    grid: int

    def describe(self) -> str:
        return (f"{_instance(self.g, self.cpl)} chunks={self.chunks} "
                f"grid={self.grid}")


def k4_plan(nnz: int, r: int, cap: int) -> K4Plan:
    """K4's launch for ``nnz`` entries at rank ``r``: the lane group of
    :func:`lane_group`, and a block a chunk of ``K4_CHUNK`` entries up to
    ``cap``, the blocks that fit the card at once (:func:`k4_cap`); more
    chunks are taken by stride."""
    g, cpl = lane_group(r)
    chunks = -(-int(nnz) // K4_CHUNK)
    return K4Plan(g, cpl, chunks, max(1, min(chunks, cap)))


def k4_plans(nnz: int, r: int, cap: int) -> List[K4Plan]:
    """The planned launch first, then grids of 1 block, half the planned
    grid and twice the cap.  All give the planned launch's bits (the tests
    and the smoke run's ``[k4-plan]`` sweep hold that)."""
    plan = k4_plan(nnz, r, cap)
    out = [plan] + [dataclasses.replace(plan, grid=max(1, grid)) for grid in (
        1, plan.grid // 2, min(plan.chunks, 2 * cap))]
    return list(dict.fromkeys(out))


def _k4_type(dtype: torch.dtype, acc32: bool) -> int:
    """K4's first C argument: 0 float64, 1 float32 summed in float64, 2
    float32 summed in float32."""
    if acc32 and dtype != torch.float32:
        raise TypeError("K4 sums in float32 only for float32 values")
    return 2 if acc32 else _f32(dtype)


def k4_cap(U: torch.Tensor, same: bool, acc32: bool = False) -> int:
    """The blocks of K4's instantiation for U's value type and rank (and
    ``U is V`` or not, and the sum's type) that fit U's card at once: its
    SMs times the occupancy query's blocks an SM."""
    dev = U.device
    return _sm_count(dev) * KERNELS["sym_contract_sum"].resident(
        dev, _k4_type(U.dtype, acc32), int(same), *lane_group(U.shape[1]))


@dataclasses.dataclass
class _K4Scratch:
    part: torch.Tensor       # one float64 partial a chunk
    ticket: torch.Tensor     # (1,) int32, 0 between calls


@dataclasses.dataclass
class _K4Tickets:
    block: torch.Tensor      # zeroed tickets, handed out from ``next`` on
    next: int = 0
    spent: List[torch.Tensor] = dataclasses.field(default_factory=list)


_K4_SCRATCH: Dict[Tuple[torch.device, int], _K4Scratch] = {}
_K4_TICKETS: Dict[torch.device, _K4Tickets] = {}
K4_TICKET_BLOCK = 4096


def _k4_scratch(dev: torch.device, stream: int, chunks: int) -> _K4Scratch:
    """K4's scratch for an eager call on ``stream``: made once (the ticket
    zeroed then), the partials grown to a power of two when a call needs
    more.  Eager calls on one stream run in order, so they share it.  Also
    keeps the pool of zeroed tickets of :func:`_graph_tickets` stocked."""
    key = (dev, stream)
    ws = _K4_SCRATCH.get(key)
    if ws is None:
        ws = _K4Scratch(torch.empty(64, dtype=torch.float64, device=dev),
                        torch.zeros(1, dtype=torch.int32, device=dev))
        _K4_SCRATCH[key] = ws
    if ws.part.numel() < chunks:
        ws.part = torch.empty(1 << (chunks - 1).bit_length(),
                              dtype=torch.float64, device=dev)
    _stock_graph_tickets(dev)
    return ws


def _stock_graph_tickets(dev: torch.device) -> None:
    """Keeps the pool of zeroed tickets of :func:`_graph_tickets` stocked
    (from an eager call: it may synchronize)."""
    pool = _K4_TICKETS.get(dev)
    if pool is None or pool.next > K4_TICKET_BLOCK // 2:
        block = torch.zeros(K4_TICKET_BLOCK, dtype=torch.int32, device=dev)
        torch.cuda.current_stream(dev).synchronize()   # zero before a replay
        # a used block stays held: captured graphs keep its tickets
        _K4_TICKETS[dev] = _K4Tickets(block, 0, [] if pool is None else
                                      pool.spent + [pool.block])


def _graph_tickets(dev: torch.device, count: int = 1) -> torch.Tensor:
    """``count`` tickets of its own for a call captured into a CUDA graph
    (K4, K12), so that no two graphs, nor a graph and the eager calls on its
    capture stream, share one: the pool's next zeroed tickets, never handed
    out again (the graph's last blocks leave them at 0 for the next
    replay).  With the pool spent, tickets zeroed inside the graph (one
    memset node more)."""
    pool = _K4_TICKETS.get(dev)
    if pool is None or pool.next + count > K4_TICKET_BLOCK:
        return torch.zeros(count, dtype=torch.int32, device=dev)
    pool.next += count
    return pool.block[pool.next - count:pool.next]


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tree32(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (a power of two) by the kernels' xor
    shuffle tree: halves added lane by lane until one is left."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _k4_acc32_plain(rows, cols, coef, U, V) -> torch.Tensor:
    """K4's float32-summing instance's sum, in its order, each product and
    sum a float32 operation: per entry, lane ``l`` of its ``G`` lanes adds
    its columns ``l, l + G, ...`` (passes of ``G * CPL``) in order; each lane
    adds coef times its column sum over the 32 entries of its warp in step
    order; an xor tree over the 32 lanes, a balanced tree over the 8 warps
    of a ``K4_CHUNK``-entry chunk; thread t of 256 adds chunks t, t + 256,
    ... in order, then the same two trees."""
    same = U is V
    nnz, r = int(rows.numel()), int(U.shape[1])
    dev = U.device
    if nnz == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    g, cpl = lane_group(r)
    lane_cols = [[c0 + lig + g * k for c0 in range(0, r, g * cpl)
                  for k in range(cpl) if c0 + lig + g * k < r]
                 for lig in range(g)]
    ui, uj = _rows(U, rows), _rows(U, cols)
    vi, vj = (ui, uj) if same else (_rows(V, rows), _rows(V, cols))
    d = torch.zeros((nnz, g), dtype=torch.float32, device=dev)
    for m in range(max(len(c) for c in lane_cols)):
        live = torch.tensor([m < len(c) for c in lane_cols], device=dev)
        col = torch.tensor([c[m] if m < len(c) else 0 for c in lane_cols],
                           device=dev)
        if same:
            t = ui[:, col] * uj[:, col]
        else:
            t = ui[:, col] * vj[:, col] + uj[:, col] * vi[:, col]
        d = torch.where(live, d + t, d)
    x = coef[:, None] * (d if same else 0.5 * d)
    # entry c * 256 + w * 32 + s * (32 / G) + q is lane (q, l) of warp w's
    # step s
    chunks = -(-nnz // K4_CHUNK)
    pad = chunks * K4_CHUNK - nnz
    x = torch.cat([x, x.new_zeros((pad, g))]).view(chunks, 8, g, 32 // g, g)
    valid = (torch.arange(chunks * K4_CHUNK, device=dev) < nnz).view(
        chunks, 8, g, 32 // g, 1)
    acc = torch.zeros((chunks, 8, 32 // g, g), dtype=torch.float32,
                      device=dev)
    for step in range(g):
        acc = torch.where(valid[:, :, step], acc + x[:, :, step], acc)
    ws = _tree32(acc.reshape(chunks, 8, 32))
    part = ((ws[:, 0] + ws[:, 1]) + (ws[:, 2] + ws[:, 3])) + (
        (ws[:, 4] + ws[:, 5]) + (ws[:, 6] + ws[:, 7]))
    rounds = -(-chunks // K4_CHUNK)
    part = torch.cat([part, part.new_zeros(rounds * K4_CHUNK - chunks)])
    live = torch.arange(rounds * K4_CHUNK, device=dev) < chunks
    acc = torch.zeros(K4_CHUNK, dtype=torch.float32, device=dev)
    for k in range(rounds):
        sl = slice(k * K4_CHUNK, (k + 1) * K4_CHUNK)
        acc = torch.where(live[sl], acc + part[sl], acc)
    ws = _tree32(acc.view(8, 32))
    return ((ws[0] + ws[1]) + (ws[2] + ws[3])) + (
        (ws[4] + ws[5]) + (ws[6] + ws[7]))


def sym_contract_sum_plain(rows, cols, coef, U, V, acc32: bool = False):
    """Plain version of K4: float64 products and sums of the (float32 or
    float64) inputs -> a 0-dim float64 tensor; with ``acc32`` float32
    products and sums of float32 inputs -> a 0-dim float32 tensor, in the
    kernel's own order (:func:`_k4_acc32_plain`), so the CPU and the card
    give the same bits: a float32 sum's rounding depends on its order."""
    rows = rows.long()
    cols = cols.long()
    same = U is V
    if acc32:
        return _k4_acc32_plain(rows, cols, coef, U, V)
    U, V, coef = U.double(), V.double(), coef.double()
    if same:
        e = torch.sum(_rows(U, rows) * _rows(U, cols), dim=-1)
    else:
        e = 0.5 * (torch.sum(_rows(U, rows) * _rows(V, cols), dim=-1)
                   + torch.sum(_rows(U, cols) * _rows(V, rows), dim=-1))
    return torch.sum(coef * e)


def sym_contract_sum(rows: torch.Tensor, cols: torch.Tensor,
                     coef: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                     acc32: bool = False) -> torch.Tensor:
    """K4: ``sum_k coef_k * sym(U V^T)[rows_k, cols_k]`` as a 0-dim float64
    tensor on U's device (``U is V`` reads U only).  float32 inputs are
    multiplied and summed in float64 (the contract of the reference's
    ``csum`` on float32, ``ltr_lowrank_sdp_tpu/ops/compsum.py:78``); the
    caller rounds the result to its compute type.  ``acc32`` (float32
    inputs only; HALLaR's ``<C, YY^T>``, a plain float32 ``jnp.sum`` in the
    reference) multiplies and sums in float32 and returns float32."""
    return sym_contract_sum_with(None, rows, cols, coef, U, V, acc32)


def sym_contract_sum_with(plan: Optional[K4Plan], rows: torch.Tensor,
                          cols: torch.Tensor, coef: torch.Tensor,
                          U: torch.Tensor, V: torch.Tensor,
                          acc32: bool = False) -> torch.Tensor:
    """:func:`sym_contract_sum` launched with ``plan`` (None:
    :func:`k4_plan` of the call).  Every plan of :func:`k4_plans` gives the
    same bits."""
    k = KERNELS["sym_contract_sum"]
    if _is_cpu(U):
        k.plain_calls += 1
        _k4_type(U.dtype, acc32)
        return sym_contract_sum_plain(rows, cols, coef, U, V, acc32)
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
    _i32(nnz + K4_CHUNK, "nnz")
    stream = _stream(dev)
    f32 = _k4_type(dt, acc32)
    if plan is None:
        plan = k4_plan(nnz, r, k4_cap(U, U is V, acc32))
    elif (plan.g, plan.cpl) != lane_group(r) or plan.chunks != -(
            -nnz // K4_CHUNK):
        raise ValueError(f"{plan.describe()} is not a plan of nnz = {nnz}, "
                         f"r = {r}")
    if torch.cuda.is_current_stream_capturing():
        # the graph's own partials (its pool holds them) and ticket
        part = torch.empty(max(1, plan.chunks), dtype=torch.float64,
                           device=dev)
        ticket = _graph_tickets(dev)
    else:
        ws = _k4_scratch(dev, stream, plan.chunks)
        part, ticket = ws.part, ws.ticket
    out = torch.empty((), dtype=torch.float32 if acc32 else torch.float64,
                      device=dev)
    k.launch(f32, rows.data_ptr(), cols.data_ptr(), coef.data_ptr(),
             U.data_ptr(), V.data_ptr(), nnz, r, 1 if U is V else 0,
             plan.g, plan.cpl, plan.grid, part.data_ptr(), ticket.data_ptr(),
             out.data_ptr(), stream)
    return out


# --------------------------------------------------------------------------- #
# K5: A(sym(U V^T)) for general sparse constraints (contraction + segment sum)
# --------------------------------------------------------------------------- #


K5_LONG_SEGMENT = 32     # a segment of at least this many entries is cut
K5_CHUNK = 8             # into chunks of at most this many entries
MAX_CPL = 8              # K5 / K6: columns per lane and pass


def lane_group(r: int) -> Tuple[int, int]:
    """``(G, CPL)`` of K5 and K6 at rank ``r``: G lanes share one entry or
    slot (the smallest power of two >= r, at most 32), and each lane keeps
    CPL = ceil(r / G) column terms, at most ``MAX_CPL`` (a wider r runs in
    passes of 32 * MAX_CPL columns).  A function of r alone: it fixes the
    order in which each output's terms are added."""
    if r < 1:
        raise ValueError(f"rank {r} < 1")
    g = 1
    while g < min(r, 32):
        g *= 2
    return g, min(MAX_CPL, -(-r // g))


def _instance(g: int, cpl: int) -> str:
    return f"G={g} CPL={cpl}"


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """K5's instantiation at one rank: ``g`` lanes per constraint, ``cpl``
    columns per lane, ``kc`` constraints per group, so a warp serves
    ``constraints_per_warp`` = 32 / g * kc neighbouring constraints."""

    g: int
    cpl: int
    kc: int

    @property
    def constraints_per_warp(self) -> int:
        return 32 // self.g * self.kc

    def describe(self) -> str:
        return f"{_instance(self.g, self.cpl)} KC={self.kc}"


K5_FILL_TILES = 16 * 1024   # tiles of one constraint a group that keep
                            # the card busy: above them, two a group


def k5_plan(r: int, m: int) -> K5Plan:
    """K5's instantiation at rank ``r`` for ``m`` constraints
    (``coo_contract_segsum.cu`` ``dispatch``).  The lane group is
    :func:`lane_group`'s but for 17 <= r <= 32, where 16 lanes of two
    columns each serve two constraints a warp step (half the shuffles and
    index loads a constraint of 32 lanes of one column).  A group takes two
    constraints (``kc``) when one a group leaves more than
    ``K5_FILL_TILES`` warps and two keep its lanes' row terms within eight,
    else one.  ``kc`` never changes the bits."""
    g, cpl = lane_group(r)
    if 17 <= r <= 32:
        g, cpl = 16, 2
    kc = 2 if (g > 1 and 2 * cpl <= MAX_CPL
               and m * g >= 32 * K5_FILL_TILES) else 1
    return K5Plan(g, cpl, kc)


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
    return coo_contract_segsum_with(None, seg, U, V, pair)


def coo_contract_segsum_with(plan: Optional[K5Plan], seg: SegCOO,
                             U: torch.Tensor, V: torch.Tensor,
                             pair: bool = False):
    """:func:`coo_contract_segsum` launched with ``plan`` (None:
    :func:`k5_plan` of the call).  Another ``kc`` gives the same bits."""
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
    if plan is None:
        plan = k5_plan(r, seg.m)
    elif plan.g < 32 and r > plan.g * plan.cpl:
        raise ValueError(f"{plan.describe()} does not cover r = {r}")
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
    k.launch(_f32(dt), seg.seg_ptr.data_ptr(), seg.rows.data_ptr(),
             seg.cols.data_ptr(), seg.coef.data_ptr(), U.data_ptr(),
             V.data_ptr(), seg.m, seg.nnz, r, mode, o1.data_ptr(), _ptr(o2),
             seg.long_thresh, _ptr(seg.chunk_ptr), nc, _ptr(seg.long_seg),
             _ptr(seg.long_ptr), n_long, _ptr(part),
             part[1].data_ptr() if nc else None, plan.g, plan.cpl, plan.kc,
             _stream(dev))
    return (o1, o2) if pair else o1


# --------------------------------------------------------------------------- #
# K6: (sum_i w_i A_i) Y over the symmetrized constraint pattern (+ beta Z)
# --------------------------------------------------------------------------- #


K6_STRANDS = 8           # matches kStrands in spmm_constr_csr.cu
K6_STEPS = 8             # a chunk is min(G, K6_STEPS) * 32 / G slots
K6_FILL_WARPS = 132 * 16     # warps that keep the H100's 132 SMs busy


@dataclasses.dataclass(frozen=True)
class K6Plan:
    """K6's launch at one rank and layout: ``g`` lanes per slot, ``cpl``
    columns per lane, ``wpr`` warps per row.  ``wpr`` only says which warp
    adds which of a row's fixed subtrees: every value gives the same bits."""

    g: int
    cpl: int
    wpr: int

    def describe(self) -> str:
        return f"{_instance(self.g, self.cpl)} W={self.wpr}"


def k6_plan(r: int, n: int, max_row: int) -> K6Plan:
    """K6's launch for rank ``r`` on a layout of ``n`` rows whose longest row
    has ``max_row`` slots: the lane group of :func:`lane_group`, and as many
    warps per row (1, 2, 4 or 8) as the rows' chunks can use
    (``min(G, K6_STEPS) * 32 / G`` slots each, dealt round-robin to
    ``K6_STRANDS`` strands; at G = 1 a warp reads one chunk of each of its
    strands at once, so such a round counts as one chunk) while ``n`` rows
    alone leave the card short of ``K6_FILL_WARPS`` warps."""
    g, cpl = lane_group(r)
    chunk = min(g, K6_STEPS) * (32 // g) * (K6_STRANDS if g == 1 else 1)
    chunks = -(-max_row // chunk)
    want = -(-K6_FILL_WARPS // max(n, 1))
    wpr = 1
    while wpr < K6_STRANDS and wpr < chunks and wpr < want:
        wpr *= 2
    return K6Plan(g, cpl, wpr)


@dataclasses.dataclass
class ConstrCSR:
    """All constraint entries of a cone as one full symmetric CSR (both
    triangles, a diagonal entry once), built on the host from the
    upper-triangle COO.  Every slot keeps the id of its constraint, so
    entries of different constraints at one (row, col) stay separate.
    ``max_row``, the longest row's slot count, picks K6's warps per row."""

    n: int
    m: int
    indptr: torch.Tensor     # (n+1,) int32
    indices: torch.Tensor    # (nnz,) int32
    vals: torch.Tensor       # (nnz,) float64 or float32
    cid: torch.Tensor        # (nnz,) int32
    max_row: int = 0

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
        per_row = np.bincount(r_all, minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(per_row, out=indptr[1:])
        return ConstrCSR(
            n=n, m=m,
            indptr=torch.tensor(indptr, dtype=torch.int32, device=device),
            indices=torch.tensor(c_all, dtype=torch.int32, device=device),
            vals=torch.tensor(v_all, dtype=dtype, device=device),
            cid=torch.tensor(k_all, dtype=torch.int32, device=device),
            max_row=int(per_row.max(initial=0)))


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
    return spmm_constr_csr_with(None, csr, w, Y, Z, beta)


def spmm_constr_csr_with(plan: Optional[K6Plan], csr: ConstrCSR,
                         w: torch.Tensor, Y: torch.Tensor,
                         Z: Optional[torch.Tensor] = None,
                         beta: float = 1.0) -> torch.Tensor:
    """:func:`spmm_constr_csr` launched with ``plan`` (None: :func:`k6_plan`
    of the call).  Other warps per row give the same bits; the tests and the
    smoke run hold every ``wpr`` to that."""
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
    if plan is None:
        plan = k6_plan(r, n, csr.max_row)
    elif plan.g < 32 and r > plan.g * plan.cpl:
        raise ValueError(f"{plan.describe()} does not cover r = {r}")
    out = torch.empty((n, r), dtype=dt, device=dev)
    k.launch(_f32(dt), csr.indptr.data_ptr(), csr.indices.data_ptr(),
             csr.vals.data_ptr(), csr.cid.data_ptr(), w.data_ptr(),
             Y.data_ptr(), _ptr(Z), out.data_ptr(), n, r, float(beta),
             plan.g, plan.cpl, plan.wpr, _stream(dev))
    return out


# --------------------------------------------------------------------------- #
# K7 / K8: the LP cone's two segment sums
# --------------------------------------------------------------------------- #


K7_ROUND = 32                  # kRound in lp_constr_segsum.cu: its slots
K8_MAX_W = 8                   # K8's widest ELL (instantiated in the .cu)


def k8_width(counts: np.ndarray) -> int:
    """K8's ELL width for columns of ``counts`` entries: the longest column
    when it has at most ``K8_MAX_W`` entries (no tail), else the 99th
    percentile of the counts, at most ``K8_MAX_W`` (the longer columns go to
    the tail list), and at least 1."""
    if counts.size == 0:
        return 1
    top = int(counts.max())
    if top <= K8_MAX_W:
        return max(1, top)
    return int(min(K8_MAX_W, max(1, np.ceil(np.percentile(counts, 99)))))


@dataclasses.dataclass
class LPEntries:
    """The LP cone's constraint entries (column, constraint, value) in two
    static orders built once on the host, each a stable sort of the problem's
    own entry order: by constraint (a CSR over the m constraints, for K7) and
    by column (a CSC over the n_cols columns, for K8's tail and the plain
    version), with the LP objective ``c``.  K8 reads the CSC as a slot-major
    ELL of ``ell_width`` slots (slot k of column j at ``k * n_cols + j``,
    the CSC's order kept, padding (0, 0)) with each column's count, -1 for a
    column longer than the width, whose entries stay in the CSC and whose id
    is on ``tail_col``."""

    m: int
    n_cols: int
    c: torch.Tensor          # (n_cols,) float64 or float32
    row_ptr: torch.Tensor    # (m+1,) int32
    row_col: torch.Tensor    # (nnz,) int32, column of each entry, CSR order
    row_val: torch.Tensor    # (nnz,) float64 or float32
    col_ptr: torch.Tensor    # (n_cols+1,) int32
    col_cid: torch.Tensor    # (nnz,) int32, constraint of each entry, CSC order
    col_val: torch.Tensor    # (nnz,) float64 or float32
    ell_width: int
    ell_cnt: torch.Tensor    # (n_cols,) int32, -1 for a tail column
    ell_cid: torch.Tensor    # (ell_width * n_cols,) int32
    ell_val: torch.Tensor    # (ell_width * n_cols,) float64 or float32
    tail_col: torch.Tensor   # (n_tail,) int32, ascending

    @property
    def nnz(self) -> int:
        return int(self.row_col.numel())

    @property
    def n_tail(self) -> int:
        return int(self.tail_col.numel())

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
        _i32(max(col.size + K7_ROUND, m + 1, n_cols + 1),
             "nnz of the LP cone")

        def ptr(ids, size):
            out = np.zeros(size + 1, np.int64)
            np.cumsum(np.bincount(ids, minlength=size), out=out[1:])
            return torch.tensor(out, dtype=torch.int32, device=device)

        by_cid = np.argsort(cid, kind="stable")
        by_col = np.argsort(col, kind="stable")
        counts = np.bincount(col, minlength=n_cols)
        width = k8_width(counts)
        _i32(width * max(n_cols, 1), "K8's ELL slots")
        col_s = col[by_col]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(col.size) - starts[col_s]
        long_col = counts > width
        keep = ~long_col[col_s]
        at = slot[keep] * n_cols + col_s[keep]
        ell_cid = np.zeros(width * n_cols, np.int64)
        ell_val = np.zeros(width * n_cols, np.float64)
        ell_cid[at] = cid[by_col][keep]
        ell_val[at] = vals[by_col][keep]
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
            col_val=torch.tensor(vals[by_col], dtype=dtype, device=device),
            ell_width=width,
            ell_cnt=torch.tensor(np.where(long_col, -1, counts),
                                 dtype=torch.int32, device=device),
            ell_cid=torch.tensor(ell_cid, dtype=torch.int32, device=device),
            ell_val=torch.tensor(ell_val, dtype=dtype, device=device),
            tail_col=torch.tensor(np.flatnonzero(long_col),
                                  dtype=torch.int32, device=device))


def lp_constr_segsum_plain(lp: LPEntries, u, v, pair: bool = False):
    """Plain version of K7."""
    cols = lp.row_col.long()

    def segsum(x):
        return torch.zeros(lp.m, dtype=x.dtype, device=x.device).index_add_(
            0, lp.row_ids, lp.row_val * x[cols])

    if pair:
        return 2.0 * segsum(u * v), segsum(v * v)
    return segsum(u * v)


def lp_constr_segsum_order(lp: LPEntries, u, v, pair: bool = False):
    """K7's own sum order in plain PyTorch, each product and sum one
    rounding as the kernel's intrinsics form it: entry j of a constraint
    into slot j mod ``K7_ROUND``, the slots added round by round, then one
    halving tree over the slots.  It gives the kernel's bits (the
    ``-m cuda`` tests hold that)."""
    ids = lp.row_ids
    cols = lp.row_col.long()
    j = torch.arange(lp.nnz, device=ids.device) - lp.row_ptr.long()[ids]
    slot, rnd = j % K7_ROUND, j // K7_ROUND
    uc, vc = u[cols], v[cols]
    terms = [lp.row_val * (uc * vc)]
    if pair:
        terms.append(lp.row_val * (vc * vc))
    outs = []
    for t in terms:
        acc = torch.zeros((lp.m, K7_ROUND), dtype=t.dtype, device=t.device)
        for r in range(int(rnd.max()) + 1 if lp.nnz else 0):
            sel = rnd == r
            acc[ids[sel], slot[sel]] += t[sel]
        while acc.shape[1] > 1:
            h = acc.shape[1] // 2
            acc = acc[:, :h] + acc[:, h:]
        outs.append(acc[:, 0])
    if pair:
        return 2.0 * outs[0], outs[1]
    return outs[0]


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


K8_THREADS = (1024, 512, 256, 128, 64, 32)   # K8's block sizes


def k8_plan(n_cols: int) -> int:
    """K8's block size: 512 threads, or the smallest block (at least a
    warp) that holds all ``n_cols`` columns: a few large blocks were
    faster than many small ones on the H100 (``PERF.md``; a column is one
    thread's chain of two dependent loads)."""
    t = 32
    while t < 512 and t < n_cols:
        t *= 2
    return t


def lp_col_wsum(lp: LPEntries, w: torch.Tensor,
                c0: float = 1.0) -> torch.Tensor:
    """K8: per LP column j, ``c0 * c[j] + sum_e val_e * w[cid_e]`` over its
    entries -> (n_cols,), the weight gather inside the kernel."""
    return lp_col_wsum_with(None, lp, w, c0)


def lp_col_wsum_with(threads: Optional[int], lp: LPEntries, w: torch.Tensor,
                     c0: float = 1.0) -> torch.Tensor:
    """:func:`lp_col_wsum` launched in blocks of ``threads`` (None:
    :func:`k8_plan` of the card).  Every block size gives the same bits."""
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
    slots = lp.ell_width * lp.n_cols
    _check(lp.ell_cnt, "ell_cnt", torch.int32, (lp.n_cols,), dev)
    _check(lp.ell_cid, "ell_cid", torch.int32, (slots,), dev)
    _check(lp.ell_val, "ell_val", dt, (slots,), dev)
    _check(lp.tail_col, "tail_col", torch.int32, (lp.n_tail,), dev)
    if threads is None:
        threads = k8_plan(lp.n_cols)
    elif threads not in K8_THREADS:
        raise ValueError(f"K8 takes blocks of {K8_THREADS} threads, got "
                         f"{threads}")
    out = torch.empty(lp.n_cols, dtype=dt, device=dev)
    k.launch(_f32(dt), lp.ell_cnt.data_ptr(), lp.ell_cid.data_ptr(),
             lp.ell_val.data_ptr(), _ptr(lp.tail_col) if lp.n_tail else None,
             lp.col_ptr.data_ptr(), _ptr(lp.col_cid) if lp.nnz else None,
             _ptr(lp.col_val) if lp.nnz else None, w.data_ptr(),
             lp.c.data_ptr(), float(c0), lp.n_cols, lp.n_tail, lp.ell_width,
             threads, out.data_ptr(), _stream(dev))
    return out


# --------------------------------------------------------------------------- #
# K9: GATv2 edge softmax and aggregation, K11: its backward (float32)
# --------------------------------------------------------------------------- #

K9_MAX_HEAD = 256       # channels a head of K9 / K11's lane layouts (8 a lane,
                        # 32 lanes); a wider head takes their wide kernels
K9_MAX_PER_LANE = 8
K9_TILE = 4             # edges a tile of K9's softmax (kTile)
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
    def by_src(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The same slots as a CSR over sources, for K11: ``(src_ptr (n+1,),
        src_slot (n_real + n,), src_dst (n_real + n,))`` int32, the slots of
        source j in increasing slot order at ``src_slot[src_ptr[j]:
        src_ptr[j+1]]`` and their destinations at the same places of
        ``src_dst``.  Built at first use on the edges' device and shared by
        the layers of one batch."""
        src = self.src.long()
        src_ptr = torch.zeros(self.n + 1, dtype=torch.long,
                              device=src.device)
        torch.cumsum(torch.bincount(src, minlength=self.n), 0,
                     out=src_ptr[1:])
        order = torch.argsort(src, stable=True)
        return (src_ptr.int(), order.int(),
                _ids_from_ptr(self.indptr)[order].int())

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
                                keep, lse, out, dout, scores=None,
                                branch=None):
    """Plain version of K11: explicit formulas of K9's VJP, with the
    LeakyReLU's derivative 1 at 0 as ``jnp.where(x >= 0, ...)`` has it and
    the softmax's score gradient with the stabiliser's term of
    :func:`_max_path`, as the JAX package's VJP has it;
    ``scores`` (E', H), the forward's own scores where given (else evaluated
    here); ``branch`` (E', H, C) bool, each message's LeakyReLU branch
    (True: the identity's) where given, else ``msg >= 0``: a reference
    that follows another program's branches, where a message within
    rounding of 0 makes the function jump (``chip_smoke.py``'s
    ``[train-step-h512x4-3g]``)."""
    heads, ch = att.shape
    hc = heads * ch
    dst = g.dst_ids
    xs, msg, s = _gatv2_messages(g, w_src, w_dst, we, we_loop, att)
    scores = s if scores is None else scores.to(s.dtype)
    alpha = torch.exp(scores - lse[dst])                       # (E', H)
    kp = torch.ones_like(alpha) if keep is None else keep
    go = dout.view(-1, heads, ch)
    dalpha = kp * torch.sum(go[dst] * xs, dim=-1)
    dd = torch.sum(go * out.view(-1, heads, ch), dim=-1)       # (n, H)
    ds = _max_path(alpha * (dalpha - dd[dst]), scores, dst, g.n)
    pos = msg >= 0 if branch is None else branch
    act = torch.where(pos, msg, LEAKY_SLOPE * msg)
    dmsg = (ds[..., None] * att * torch.where(pos, 1.0, LEAKY_SLOPE)
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


def _pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def gatv2_lanes(heads: int, ch: int) -> Tuple[int, int]:
    """K11's lane layout for one group of ``heads`` x ``ch`` (a group of
    :func:`k11_groups`) of heads of at most ``K9_MAX_HEAD`` channels:
    ``(lanes per head, channels per lane)``.  The heads split a warp's 32
    lanes into groups of 32 / (heads rounded up to a power of two) lanes and
    a lane holds at most 8 channels."""
    if not 1 <= ch <= K9_MAX_HEAD:
        raise ValueError(f"K11's lanes take heads of 1 to {K9_MAX_HEAD} "
                         f"channels (wider: its wide kernels); got {ch}")
    hp = _pow2(heads)
    if heads >= 1 and hp <= 32:
        lph = 32 // hp
        per_lane = -(-int(ch) // lph)
        if per_lane <= K9_MAX_PER_LANE:
            return lph, per_lane
    raise ValueError(f"{heads} heads x {ch} channels is not one K11 group "
                     f"(see k11_groups)")


@dataclasses.dataclass(frozen=True)
class K9Plan:
    """K9's launch for heads x channels: ``lph`` lanes a head with ``p``
    channels a lane, ``hpg`` heads a group and ``groups`` groups a node (a
    warp each), fixed by the shape; ``s`` sub-warps taking different edges
    of a tile, ``b`` tiles loaded before their arithmetic and ``v`` floats a
    load, which never change the bits.  ``p = 0`` is the wide kernel of a
    head past ``K9_MAX_HEAD`` channels (a warp a head, passes of 256)."""

    v: int
    p: int
    s: int
    b: int
    lph: int
    hpg: int
    groups: int

    def describe(self) -> str:
        if self.p == 0:
            return f"V={self.v} wide (a warp a head) groups={self.groups}"
        return (f"V={self.v} P={self.p} S={self.s} B={self.b} lph={self.lph} "
                f"groups={self.groups}x{self.hpg}")


def _k9_batch(p: int, s: int) -> int:
    """Tiles a batch: one, two at four sub-warps (the fastest at the serve,
    training and width phase shapes on the H100 in a sweep of 1, 2 and 4
    tiles at every sub-warp count, PERF.md: two tiles at two sub-warps cost
    occupancy on the largest graph)."""
    return max(1, s // 2)


def k9_plan(heads: int, ch: int) -> K9Plan:
    """K9's launch for ``heads`` x ``ch``: 4 channels a lane (8 past 128
    channels a head) in float4 / float2 loads where ``ch`` allows them,
    lanes a head the next power of two that covers the head, as many heads a
    warp as fit (the rest in further groups), sub-warps where a group takes
    at most half the warp (at most 4), and :func:`_k9_batch` tiles a batch;
    past ``K9_MAX_HEAD`` channels a head, the wide kernel."""
    if heads < 1 or ch < 1:
        raise ValueError(f"K9 needs a head of a channel, got {heads} x {ch}")
    v = 4 if ch % 4 == 0 else 2 if ch % 2 == 0 else 1
    if ch > K9_MAX_HEAD:
        return K9Plan(v, 0, 1, 1, 32, 1, heads)
    p = 4 if ch <= 128 else 8
    lph = _pow2(-(-ch // p))
    hpg = min(heads, 32 // lph)
    s = min(4, 32 // _pow2(hpg * lph))
    return K9Plan(v, p, s, _k9_batch(p, s), lph, hpg, -(-heads // hpg))


def k9_plans(heads: int, ch: int) -> List[K9Plan]:
    """The planned launch first, then every other instantiated launch of the
    shape: one tile a batch (at four sub-warps), fewer sub-warps, scalar
    loads.  All give the planned launch's bits (the ``-m cuda`` tests and
    the smoke run's ``[k9-plan]`` sweep hold that)."""
    plan = k9_plan(heads, ch)
    out = [plan]
    if plan.p == 0:
        out.append(dataclasses.replace(plan, v=1))
        return [q for q in dict.fromkeys(out)
                if (q.v, q.p, q.s, q.b) in K9_INSTANCES]
    out.append(dataclasses.replace(plan, b=1))
    s = plan.s
    while s > 1:
        s //= 2
        out.append(dataclasses.replace(plan, s=s, b=_k9_batch(plan.p, s)))
    if plan.v > 1:
        out.append(dataclasses.replace(plan, v=1))
    return [q for q in dict.fromkeys(out)
            if (q.v, q.p, q.s, q.b) in K9_INSTANCES]


# (v, p, s, b) of K9_CASE in gatv2_softmax_agg.cu
K9_INSTANCES = frozenset(
    [(4, 4, 1, 1), (4, 4, 2, 1), (4, 4, 4, 2), (4, 4, 4, 1), (4, 8, 1, 1)]
    + [(v, 4, 1, 1) for v in (2, 1)] + [(v, 4, 2, 1) for v in (2, 1)]
    + [(v, 4, 4, 2) for v in (2, 1)] + [(v, 8, 1, 1) for v in (2, 1)]
    + [(v, 0, 1, 1) for v in (4, 2, 1)])


def _check_gatv2(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep, dev,
                 scores=None):
    heads, ch = att.shape
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
    if scores is not None:
        _check(scores, "scores", torch.float32, (g.n_slots, heads), dev)
    _i32(max(g.n, g.n_slots) * hc, "slots * channels")


def _aligned(plan: K9Plan, *ts) -> K9Plan:
    """``plan``, or its scalar-load twin where a row pointer is not aligned
    to its vector loads (the same bits)."""
    if plan.v > 1 and any(t is not None and t.numel() and
                          t.data_ptr() % (4 * plan.v) for t in ts):
        return dataclasses.replace(plan, v=1)
    return plan


def _gatv2_forward(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep,
                   with_lse: bool, plan: Optional[K9Plan] = None,
                   scores: Optional[torch.Tensor] = None):
    """K9 (launched with ``plan``, None: :func:`k9_plan`) or, for CPU
    tensors, its plain version -> (out, lse or None); ``scores`` (E', H),
    where given, receives every slot's score (the training instance; K11
    forms alpha from them)."""
    k = KERNELS["gatv2_softmax_agg"]
    if _is_cpu(w_src):
        k.plain_calls += 1
        out, lse = _gatv2_plain(g, w_src, w_dst, we, we_loop, att, keep)
        if scores is not None:
            scores.copy_(_gatv2_messages(g, w_src, w_dst, we, we_loop,
                                         att)[2])
        return out, lse if with_lse else None
    dev = w_src.device
    _check_gatv2(g, w_src, w_dst, we, we_loop, att, keep, dev, scores)
    heads, ch = att.shape
    if plan is None:
        plan = _aligned(k9_plan(heads, ch), w_src, w_dst, we, we_loop, att)
    elif ((plan.v, plan.p, plan.s, plan.b) not in K9_INSTANCES
          or dataclasses.replace(plan, v=1, s=1, b=1) != dataclasses.replace(
              k9_plan(heads, ch), v=1, s=1, b=1)
          or plan.s > k9_plan(heads, ch).s
          or _aligned(plan, w_src, w_dst, we, we_loop, att) != plan):
        raise ValueError(f"{plan.describe()} is not a launch of {heads} "
                         f"heads x {ch} channels on these tensors")
    out = torch.empty((g.n, heads * ch), dtype=torch.float32, device=dev)
    lse = (torch.empty((g.n, heads), dtype=torch.float32, device=dev)
           if with_lse or scores is not None else None)
    _i32(g.n * plan.groups, "nodes * groups")
    k.launch(g.indptr.data_ptr(), g.src.data_ptr(), g.erow.data_ptr(),
             w_src.data_ptr(), w_dst.data_ptr(),
             we.data_ptr() if g.n_real else None,
             we_loop.data_ptr(), att.data_ptr(), _ptr(keep), g.n, g.n_real,
             heads, ch, plan.lph, plan.hpg, plan.groups, plan.v, plan.p,
             plan.s, plan.b, LEAKY_SLOPE, out.data_ptr(), _ptr(lse),
             _ptr(scores), _stream(dev))
    return out, lse if with_lse else None


def gatv2_softmax_agg_with(plan: Optional[K9Plan], g: EdgeCSR, w_src, w_dst,
                           we, we_loop, att, keep=None, with_lse=False,
                           scores=None):
    """K9 launched with ``plan`` (None: :func:`k9_plan`), no autograd node:
    (out, lse or None), and the scores into ``scores`` where given.  Every
    plan of :func:`k9_plans` gives the same bits."""
    return _gatv2_forward(g, w_src, w_dst, we, we_loop, att, keep, with_lse,
                          plan, scores)


def gatv2_softmax_agg_bwd(g: EdgeCSR, w_src, w_dst, we, we_loop, att, keep,
                          lse, out, dout, scores=None):
    """K11: the gradients ``(d_w_src, d_w_dst, d_we, d_we_loop, d_att)`` of
    K9's inputs from ``dout`` (n, heads * ch), the gradient of its output,
    given K9's ``lse``, ``out`` and ``scores`` (:func:`_gatv2_forward`) for
    the same inputs (and ``keep``).  The kernel takes K9's scores, which the
    cancelling sums d_w_dst, d_we_loop and d_att need; the plain version
    evaluates them where they are not given."""
    k = KERNELS["gatv2_softmax_agg_bwd"]
    if _is_cpu(dout):
        k.plain_calls += 1
        return gatv2_softmax_agg_bwd_plain(g, w_src, w_dst, we, we_loop, att,
                                           keep, lse, out, dout, scores)
    dev = dout.device
    if scores is None:
        raise ValueError("K11 needs K9's scores (_gatv2_forward(scores=))")
    _check_gatv2(g, w_src, w_dst, we, we_loop, att, keep, dev, scores)
    heads, ch = att.shape
    hc = heads * ch
    _check(lse, "lse", torch.float32, (g.n, heads), dev)
    _check(out, "out", torch.float32, (g.n, hc), dev)
    _check(dout, "dout", torch.float32, (g.n, hc), dev)
    src_ptr, src_slot, src_dst = g.by_src
    stream = _stream(dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    d_w_src, d_w_dst, d_we = empty(g.n, hc), empty(g.n, hc), empty(
        g.n_real, hc)
    d_we_loop, d_att = empty(hc), empty(heads, ch)

    def at(t, h0, per_head):
        """The address of head h0's first value in ``t`` (None: null),
        ``per_head`` float32 values a head."""
        if t is None or not t.numel():
            return None
        return t.data_ptr() + 4 * h0 * per_head

    for h0, hg in k11_groups(heads, ch):
        plan = k11_plan(hg, ch)
        max_blocks = k11_max_blocks(g.n, _sm_count(dev) * k.resident(
            dev, plan.p, plan.s))
        akds, bits, part = k11_scratch(g.n_slots, g.n, hg, ch, max_blocks,
                                       dev)
        k.launch(g.indptr.data_ptr(), g.src.data_ptr(), g.erow.data_ptr(),
                 src_ptr.data_ptr(), src_slot.data_ptr(), src_dst.data_ptr(),
                 at(w_src, h0, ch), at(w_dst, h0, ch), at(we, h0, ch),
                 at(we_loop, h0, ch), at(att, h0, ch), at(keep, h0, 1),
                 at(lse, h0, 1), at(scores, h0, 1), at(out, h0, ch),
                 at(dout, h0, ch), g.n,
                 g.n_real, hg, ch, hc, heads, LEAKY_SLOPE, plan.p, plan.s,
                 max_blocks, at(d_w_src, h0, ch), at(d_w_dst, h0, ch),
                 at(d_we, h0, ch), at(d_we_loop, h0, ch), at(d_att, h0, ch),
                 akds.data_ptr(), bits.data_ptr(), part.data_ptr(), stream)
    return d_w_src, d_w_dst, d_we, d_we_loop, d_att


def k11_groups(heads: int, ch: int) -> List[Tuple[int, int]]:
    """K11's calls for ``heads`` x ``ch``: ``(first head, heads)`` of each,
    in head order.  One call where its lanes (:func:`gatv2_lanes`) take
    every head; else groups of the largest power of two of heads whose
    lanes hold a head at 8 channels a lane; a head past ``K9_MAX_HEAD``
    channels is a call of its own (the wide kernels).  Fixed by the
    shape."""
    hg = 32
    while hg > 1 and -(-ch // (32 // hg)) > K9_MAX_PER_LANE:
        hg //= 2
    if _pow2(heads) <= hg:
        return [(0, heads)]
    return [(h0, min(hg, heads - h0)) for h0 in range(0, heads, hg)]


@dataclasses.dataclass(frozen=True)
class K11Plan:
    """K11's lanes for heads x channels: the warp cut into ``s`` sub-warps
    of 32 / s lanes, each taking one slot a step with K9's head split inside
    it and ``p`` channels a lane; ``words`` 32-bit words of msg signs a
    slot."""

    s: int
    p: int
    words: int

    def describe(self) -> str:
        return f"S={self.s} P={self.p}"


def k11_plan(heads: int, ch: int) -> K11Plan:
    """K11's lanes: where K9's layout (:func:`gatv2_lanes`) leaves a lane
    one channel, four sub-warps (two where it leaves two), as far as the
    head's lanes divide; one elsewhere.  A head past ``K9_MAX_HEAD``
    channels (one a call): the wide kernels, ``p = 0``, 8 sign words a pass
    of 256 channels."""
    if ch > K9_MAX_HEAD:
        if heads != 1:
            raise ValueError("K11 takes a head past 256 channels alone")
        return K11Plan(1, 0, 8 * -(-int(ch) // 256))
    lph, per_lane = gatv2_lanes(heads, ch)
    s = min(lph, {1: 4, 2: 2}.get(per_lane, 1))
    p = -(-int(ch) // (lph // s))
    return K11Plan(s, p, -(-(p * (32 // s)) // 32))


def k11_max_blocks(n: int, cap: int) -> int:
    """The blocks of K11's destination pass, one block partial of d_att /
    d_we_loop each: a warp a destination, at most ``cap`` blocks of 8 warps
    (the blocks that fit the card at once, from CUDA's occupancy query);
    more destinations are taken by stride."""
    return max(1, min(-(-int(n) // 8), cap))


def k11_scratch(n_slots: int, n: int, heads: int, ch: int, max_blocks: int,
                dev) -> Tuple[torch.Tensor, ...]:
    """K11's scratch for one call: per slot and head the float2 (alpha keep,
    ds), per slot :func:`k11_plan`'s words of msg signs, and the
    destination pass's block partials (``max_blocks``, 2 H C) float64.  The
    wide kernels keep (alpha keep, ds) in float64 and a partial a warp."""
    wide = k11_plan(heads, ch).p == 0
    return (torch.empty((n_slots, heads, 4 if wide else 2),
                        dtype=torch.float32, device=dev),
            torch.empty((n_slots, k11_plan(heads, ch).words),
                        dtype=torch.int32, device=dev),
            torch.empty(((8 if wide else 1) * max_blocks if n else 0,
                         2 * heads * ch), dtype=torch.float64, device=dev))


class _GATv2SoftmaxAgg(torch.autograd.Function):
    """K9 forward (with its lse), K11 backward; their plain versions for CPU
    tensors."""

    @staticmethod
    def forward(ctx, g, keep, w_src, w_dst, we, we_loop, att):
        # on the card K11 takes K9's own scores; the CPU's plain backward
        # evaluates them as the plain forward did, to the same bits
        scores = None if _is_cpu(w_src) else torch.empty(
            (g.n_slots, att.shape[0]), dtype=torch.float32,
            device=w_src.device)
        out, lse = _gatv2_forward(g, w_src, w_dst, we, we_loop, att, keep,
                                  True, scores=scores)
        ctx.g = g
        ctx.save_for_backward(w_src, w_dst, we, we_loop, att, keep, lse, out,
                              scores)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        (w_src, w_dst, we, we_loop, att, keep, lse, out,
         scores) = ctx.saved_tensors
        return (None, None) + gatv2_softmax_agg_bwd(
            ctx.g, w_src, w_dst, we, we_loop, att, keep, lse, out,
            dout.contiguous(), scores)


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
    in the CSR's slot order.  The kernel takes any width (:func:`k9_plan`:
    head groups, and a warp a head past ``K9_MAX_HEAD`` channels).  When an
    input requires a
    gradient, the call is an autograd node whose backward is K11 (in head
    groups, :func:`k11_groups`)."""
    tensors = (w_src, w_dst, we, we_loop, att)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _GATv2SoftmaxAgg.apply(g, keep, *tensors)
    return _gatv2_forward(g, *tensors, keep, False)[0]


# --------------------------------------------------------------------------- #
# K10: mean / max / attention pooling per graph, K12: its backward (float32)
# --------------------------------------------------------------------------- #

K10_CHUNK = 256          # nodes a block (kChunk in graph_pool.cu, kChunkNodes
                         # in graph_pool_bwd.cu)
K10_MAX_D = 256          # columns a block (kMaxD in graph_pool*.cu): wider
                         # rows are cut into column blocks of this width
K10_BUF = 32             # floats of rows a lane of K10 loads ahead (kBuf)
K10_DEPTHS = (1, 2, 4, 8)    # rows a sub-warp of K10 may load ahead


@dataclasses.dataclass(frozen=True)
class K10Plan:
    """K10's launch: ``lanes`` lanes a node (the sub-warp, which fixes the
    sum order) and ``cpl`` channels a lane, both from d alone; ``vec`` 4
    for float4 loads or 1 for scalar ones, and ``depth`` rows a sub-warp
    loads before it adds them (at most ``K10_BUF / cpl``).  ``vec`` and
    ``depth`` never change the bits."""

    lanes: int
    cpl: int
    vec: int
    depth: int

    def describe(self) -> str:
        return (f"L={self.lanes} CPL={self.cpl} vec={self.vec} "
                f"depth={self.depth}")


def k10_lanes(d: int) -> int:
    """K10's lanes a node at width ``d``: the power of two that covers a
    column block (at most ``K10_MAX_D`` columns) four channels a lane, at
    most 32 (then 4 or 8 channels a lane).  A function of d alone."""
    need = -(-min(d, K10_MAX_D) // 4)
    lanes = 1
    while lanes < min(need, 32):
        lanes *= 2
    return lanes


def k10_cpl(d: int) -> int:
    """K10's channels a lane: 8 where a column block is wider than 32 lanes
    of 4, else 4."""
    return 8 if min(d, K10_MAX_D) > 4 * k10_lanes(d) else 4


def k10_plan(d: int, aligned: bool = True) -> K10Plan:
    """K10's planned launch at width ``d``: float4 loads where d is a
    multiple of 4 and the rows are 16-byte aligned, as many rows ahead as
    a lane's buffer holds."""
    cpl = k10_cpl(d)
    return K10Plan(k10_lanes(d), cpl, 4 if d % 4 == 0 and aligned else 1,
                   K10_BUF // cpl)


def k10_plans(d: int, aligned: bool = True) -> List[K10Plan]:
    """The planned launch first, then every other depth and the scalar
    loads: all give the planned launch's bits (the tests and the smoke run's
    ``[k10-plan]`` sweep hold that)."""
    plan = k10_plan(d, aligned)
    out = [plan] + [dataclasses.replace(plan, depth=k) for k in K10_DEPTHS
                    if k * plan.cpl <= K10_BUF]
    out.append(dataclasses.replace(plan, vec=1))
    return list(dict.fromkeys(out))


def k10_part_width(d: int) -> int:
    """Floats of one chunk's partial in K10's scratch: (m, l) padded to 4
    for each column block of ``K10_MAX_D``, then four columns of d rounded
    up to a multiple of 4 (float4 aligned)."""
    return 4 * -(-d // K10_MAX_D) + 4 * (-(-d // 4) * 4)


@dataclasses.dataclass
class GraphSegments:
    """The graphs of a batch as contiguous node ranges ``ptr[b]:ptr[b+1]``,
    each cut on the host into chunks of at most ``K10_CHUNK`` nodes
    (``chunk_start`` / ``chunk_end``; graph b owns chunks
    ``chunk_ptr[b]:chunk_ptr[b+1]``, none when it is empty, and
    ``chunk_graph`` names the graph of each chunk); ``empty`` lists the
    graphs without a node (K10 gives each a block that writes zeros)."""

    num_graphs: int
    n_nodes: int
    ptr: torch.Tensor          # (B+1,) int32
    chunk_ptr: torch.Tensor    # (B+1,) int32
    chunk_start: torch.Tensor  # (n_chunks,) int32
    chunk_end: torch.Tensor    # (n_chunks,) int32
    chunk_graph: torch.Tensor  # (n_chunks,) int32
    empty: torch.Tensor        # (n_empty,) int32

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_start.numel())

    @property
    def n_empty(self) -> int:
        return int(self.empty.numel())

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
                             chunk_end=t(end), chunk_graph=t(which),
                             empty=t(np.flatnonzero(counts == 0)))

    @staticmethod
    def from_batch(batch: torch.Tensor, num_graphs: int) -> "GraphSegments":
        """From the (N,) graph id of every node, which must be sorted."""
        ids = batch.detach().cpu().numpy()
        if ids.size and (np.any(np.diff(ids) < 0) or ids[0] < 0
                         or ids[-1] >= num_graphs):
            raise ValueError("graph ids must be sorted and in [0, num_graphs)")
        return GraphSegments.from_counts(
            np.bincount(ids, minlength=num_graphs), batch.device)


@dataclasses.dataclass
class _K10Scratch:
    part: torch.Tensor       # chunk partials, float32
    ticket: torch.Tensor     # int32 tickets, 0 between calls


_K10_SCRATCH: Dict[Tuple[torch.device, int], _K10Scratch] = {}


def _k10_scratch(dev: torch.device, stream: int, part: int,
                 tickets: int) -> _K10Scratch:
    """K10's scratch for a call of ``part`` partial floats and ``tickets``
    tickets.  An eager call on ``stream`` shares it with that stream's other
    eager calls (they run in order), grown to a power of two when a call
    needs more (new tickets zeroed); a call captured into a CUDA graph gets
    its own partials and tickets zeroed inside the graph."""
    if torch.cuda.is_current_stream_capturing():
        return _K10Scratch(
            torch.empty(max(part, 1), dtype=torch.float32, device=dev),
            torch.zeros(max(tickets, 1), dtype=torch.int32, device=dev))
    key = (dev, stream)
    ws = _K10_SCRATCH.get(key)
    if ws is None:
        ws = _K10Scratch(torch.empty(1024, dtype=torch.float32, device=dev),
                         torch.zeros(64, dtype=torch.int32, device=dev))
        _K10_SCRATCH[key] = ws
    if ws.part.numel() < part:
        ws.part = torch.empty(1 << (part - 1).bit_length(),
                              dtype=torch.float32, device=dev)
    if ws.ticket.numel() < tickets:
        ws.ticket = torch.zeros(1 << (tickets - 1).bit_length(),
                                dtype=torch.int32, device=dev)
    return ws


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


def _max_path(ds, score, seg, n_seg):
    """The score gradient ``ds`` of a segment softmax plus the term that
    the JAX package's VJP routes through the softmax's stabiliser
    (``score - segment_max(score)``, ``gatv2.py:28``, ``layers.py:93``): each
    segment's ``-sum ds``, split equally among the scores that equal the
    segment's maximum.  In exact arithmetic that sum is 0; in float32 it is
    the rounding left in ``ds``, and without this term it stays in every
    leaf behind the softmax."""
    shape = (n_seg,) + tuple(score.shape[1:])
    top = torch.full(shape, -torch.inf, dtype=score.dtype,
                     device=score.device).scatter_reduce_(
        0, seg.view(-1, *([1] * (score.dim() - 1))).expand_as(score), score,
        "amax")
    hit = (score == top[seg]).to(ds.dtype)
    ties = torch.zeros(shape, dtype=ds.dtype, device=ds.device).index_add_(
        0, seg, hit)
    total = torch.zeros(shape, dtype=ds.dtype, device=ds.device).index_add_(
        0, seg, ds)
    return ds - hit * (total / torch.clamp(ties, min=1.0))[seg]


def graph_pool_bwd_plain(seg: GraphSegments, x, score, keep, out, stats,
                         ties, dout):
    """Plain version of K12: explicit formulas of K10's VJP, the max's
    gradient split equally among tied nodes, as ``jax.ops.segment_max``'s
    is, and the attention softmax's score gradient with the stabiliser's
    term of :func:`_max_path`, as the JAX package's VJP has it."""
    d = x.shape[1]
    batch = seg.batch_ids
    counts = (seg.ptr[1:] - seg.ptr[:-1]).to(x.dtype)
    dmean = dout[:, :d] / torch.clamp(counts, min=1.0)[:, None]
    dmax = dout[:, d:2 * d] / torch.clamp(ties, min=1.0)
    dattn = dout[:, 2 * d:]
    w = torch.exp(score - stats[batch, 0]) / (stats[batch, 1] + 1e-16)
    kw = w if keep is None else keep * w
    a = torch.sum(x * dattn[batch], dim=1)
    ka = a if keep is None else keep * a
    dot = torch.sum(dattn * out[:, 2 * d:], dim=1)
    dx = (dmean[batch]
          + torch.where(x == out[batch, d:2 * d], dmax[batch], 0.0)
          + kw[:, None] * dattn[batch])
    dscore = _max_path(w * (ka - dot[batch]), score, batch, len(counts))
    return dx, dscore


def _check_pool(seg: GraphSegments, x, score, keep, dev):
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (N, d) with d >= 1, got "
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
    _check(seg.empty, "empty", torch.int32, (seg.n_empty,), dev)
    _i32(n * d, "N * d")
    _i32(nc * k10_part_width(d), "K10's partials")


def _graph_pool_forward(seg: GraphSegments, x, score, keep, train: bool,
                        plan: Optional[K10Plan] = None):
    """K10 (launched with ``plan``; None: :func:`k10_plan`) or, for CPU
    tensors, its plain version -> (out, stats, ties), the last two only with
    ``train``."""
    k = KERNELS["graph_pool"]
    if _is_cpu(x):
        k.plain_calls += 1
        out, stats, ties = _graph_pool_plain(seg, x, score, keep)
        return (out, stats, ties) if train else (out, None, None)
    dev = x.device
    _check_pool(seg, x, score, keep, dev)
    n, d = x.shape
    B, nc = seg.num_graphs, seg.n_chunks
    aligned = x.data_ptr() % 16 == 0
    if plan is None:
        plan = k10_plan(d, aligned)
    elif (plan.lanes != k10_lanes(d) or plan.cpl != k10_cpl(d)
          or plan.depth not in K10_DEPTHS
          or plan.depth * plan.cpl > K10_BUF or plan.vec not in (1, 4)
          or (plan.vec == 4 and (d % 4 or not aligned))):
        raise ValueError(f"{plan.describe()} is not a plan of d = {d}")
    ny = -(-d // K10_MAX_D)
    ws = _k10_scratch(dev, _stream(dev), nc * k10_part_width(d), B * ny)
    out = torch.empty((B, 3 * d), dtype=torch.float32, device=dev)
    stats = ties = None
    if train:
        stats = torch.empty((B, 2), dtype=torch.float32, device=dev)
        ties = torch.empty((B, d), dtype=torch.float32, device=dev)
    k.launch(seg.ptr.data_ptr(), seg.chunk_ptr.data_ptr(),
             _ptr(seg.chunk_start) if nc else None,
             _ptr(seg.chunk_end) if nc else None,
             _ptr(seg.chunk_graph) if nc else None,
             _ptr(seg.empty) if seg.n_empty else None, seg.n_empty,
             x.data_ptr() if n else None, score.data_ptr() if n else None,
             _ptr(keep) if n else None, B, nc, d, plan.lanes, plan.cpl,
             plan.vec, plan.depth, ws.part.data_ptr(), ws.ticket.data_ptr(),
             out.data_ptr(), _ptr(stats), _ptr(ties), _stream(dev))
    return out, stats, ties


def graph_pool_with(plan: Optional[K10Plan], seg: GraphSegments, x, score,
                    keep=None, train: bool = False):
    """K10 launched with ``plan`` (no autograd node) -> (out, stats, ties),
    the last two only with ``train``.  Every plan of :func:`k10_plans` gives
    the same bits."""
    return _graph_pool_forward(seg, x, score, keep, train, plan)


def graph_pool_bwd(seg: GraphSegments, x, score, keep, out, stats, ties,
                   dout):
    """K12: the gradients ``(dx (N, d), dscore (N,))`` of K10's inputs from
    ``dout`` (B, 3 d), given K10's ``out``, ``stats`` and ``ties`` for the
    same inputs (and ``keep``); one launch."""
    return graph_pool_bwd_with(None, seg, x, score, keep, out, stats, ties,
                               dout)


def graph_pool_bwd_with(plan: Optional[K10Plan], seg: GraphSegments, x,
                        score, keep, out, stats, ties, dout):
    """K12 launched with ``plan`` (None: :func:`k10_plan`; K12 walks its
    nodes in K10's layout).  Every plan of :func:`k10_plans` gives the same
    bits."""
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
    aligned = x.data_ptr() % 16 == 0
    if plan is None:
        plan = k10_plan(d, aligned)
    elif plan not in k10_plans(d, aligned):
        raise ValueError(f"{plan.describe()} is not a plan of d = {d}")
    ny = -(-d // K10_MAX_D)
    dx = torch.empty((n, d), dtype=torch.float32, device=dev)
    dscore = torch.empty(n, dtype=torch.float32, device=dev)
    part_ds = torch.empty(max(nc, 1), dtype=torch.float64, device=dev)
    part_tie = torch.empty(2 * max(nc, 1), dtype=torch.int32, device=dev)
    part_a = (torch.empty(nc * ny * K10_CHUNK, dtype=torch.float64,
                          device=dev) if ny > 1 and nc else None)
    if torch.cuda.is_current_stream_capturing():
        ticket = _graph_tickets(dev, k12_tickets(B, nc, d))
    else:
        ticket = _k10_scratch(dev, _stream(dev), 0,
                              k12_tickets(B, nc, d)).ticket
        _stock_graph_tickets(dev)
    k.launch(seg.ptr.data_ptr(), seg.chunk_ptr.data_ptr(),
             _ptr(seg.chunk_start) if nc else None,
             _ptr(seg.chunk_end) if nc else None,
             _ptr(seg.chunk_graph) if nc else None,
             x.data_ptr() if n else None, score.data_ptr() if n else None,
             _ptr(keep) if n else None, out.data_ptr(), stats.data_ptr(),
             ties.data_ptr(), dout.data_ptr(), B, nc, d, plan.lanes,
             plan.cpl, plan.vec, plan.depth, dx.data_ptr() if n else None,
             dscore.data_ptr() if n else None, part_ds.data_ptr(),
             part_tie.data_ptr(), _ptr(part_a), ticket.data_ptr(),
             _stream(dev))
    return dx, dscore


def k12_tickets(n_graphs: int, n_chunks: int, d: int) -> int:
    """K12's tickets: one a graph, then one a chunk where d is cut into
    column blocks (the chunk's last column block adds their dots)."""
    return n_graphs + (n_chunks if d > K10_MAX_D else 0)


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
    x]`` -> (B, 3 d), from x (N, d) (column blocks of ``K10_MAX_D`` on the
    card), the attention scores (N,)
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
K13_MIN_TILE = 256       # the gather plan: indices per block at least,
K13_MAX_BLOCKS = 8 * 132  # and at most 8 blocks per SM of the H100
K13_STEPS = 8            # kSteps: rows a strand of a counts-plan chunk
K13_HIST = 2048          # indices a block of the histogram at least (its
                         # 256 threads load 8 each, kBatch, at once)
K13_MAX_SMEM_BINS = 48 * 1024   # kMaxSmemBins: the shared histogram's N
K13_SMEM_RATIO = 16      # the shared histogram planned while N grid <= 16 M


@dataclasses.dataclass(frozen=True)
class K13Plan:
    """K13's launch: the counts plan (``counts``: a histogram of the
    indices, then one pass over Y; the histogram in shared memory with
    ``smem``, else by warp-aggregated global atomics), or the gather (a
    tile of indices a block, the kernel's first design).  Both counts plans
    give the same bits."""

    counts: bool
    smem: bool = False

    @property
    def mode(self) -> int:
        """The C entry point's ``mode``."""
        return 1 + self.smem if self.counts else 0

    def describe(self) -> str:
        if not self.counts:
            return "gather"
        return f"counts {'smem' if self.smem else 'match'}"


def k13_lanes(R: int) -> int:
    """L: lanes a row of Y (C = ceil(R / L) <= 8 columns a lane)."""
    return min(32, _pow2(R))


def k13_chunk_rows(R: int) -> int:
    """Rows of Y a chunk of the counts plan's pass: ``K13_STEPS`` rows a
    strand of L lanes, 256 / L strands."""
    return K13_STEPS * (256 // k13_lanes(R))


def k13_plan(N: int, M: int, R: int) -> K13Plan:
    """The counts plan where its bytes, 4 (M + N (R + 2)) (idx, Y, the
    counts written and read), are fewer than the gather's, 4 M (R + 1) (idx
    and the gathered rows); else the gather."""
    if M + N * (R + 2) >= M * (R + 1):
        return K13Plan(False)
    # each block of the shared histogram zeroes and flushes N bins: it is
    # planned where N fits and a block's indices are at least N / 16, since
    # on the card it ties with the warp-aggregated atomics at N grid = 16 M
    # and loses past it (PERF.md, [k13-plan])
    return K13Plan(True, smem=N <= K13_MAX_SMEM_BINS and N * k13_grid(
        N, M, R) <= K13_SMEM_RATIO * M)


def k13_plans(N: int, M: int, R: int) -> List[K13Plan]:
    """The planned launch first, then every other plan: the gather and the
    two counts plans (the shared histogram where N fits)."""
    plans = [K13Plan(False), K13Plan(True)] + (
        [K13Plan(True, smem=True)] if N <= K13_MAX_SMEM_BINS else [])
    plan = k13_plan(N, M, R)
    return [plan] + [p for p in plans if p != plan]


def gather_rowsum_grid(M: int) -> Tuple[int, int]:
    """(blocks, indices per block) of the gather plan's first launch: tiles
    of at least ``K13_MIN_TILE`` indices, at most ``K13_MAX_BLOCKS``
    blocks, none empty (one block for M = 0, which writes zeros)."""
    tile = max(K13_MIN_TILE, -(-M // K13_MAX_BLOCKS))
    return max(1, -(-M // tile)), tile


def k13_gather_bound(Y, idx) -> float:
    """The gather plan's float32 rounding bound, max |gather - exact|: a
    term passes at most tile / 8 additions in its lane, 8 across the warps
    and one a block in the combine, each rounded to 2^-24, so the bound is
    (tile / 8 + 8 + blocks) 2^-24 max_j sum_i |Y[idx[i], j]|.  On many equal
    indices the gather's error can pass 1e-5 of the sum (PERF.md) while it
    stays within this bound; the counts plans round one product a row
    instead."""
    Y, idx = _host(Y, idx)
    blocks, tile = gather_rowsum_grid(idx.size)
    terms = np.abs(Y.astype(np.float64)[idx.astype(np.int64)]).sum(0)
    return (tile // 8 + 8 + blocks) * 2.0 ** -24 * float(terms.max(initial=0))


def k13_grid(N: int, M: int, R: int) -> int:
    """The counts plan's blocks: one a chunk of the pass or one a
    ``K13_HIST`` indices of the histogram, whichever is more, at most
    ``K13_MAX_BLOCKS``."""
    chunks = -(-N // k13_chunk_rows(R))
    return max(1, min(K13_MAX_BLOCKS, max(chunks, -(-M // K13_HIST))))


def gather_rowsum_plain(Y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: ``Y[idx].sum(0, keepdim=True)``."""
    return Y.index_select(0, idx).sum(0, keepdim=True)


def gather_rowsum_order(Y, idx) -> torch.Tensor:
    """The counts plan's result, bit for bit, evaluated on the host with
    numpy in the kernel's order: c_k = #{i : idx[i] = k} (indices outside
    [0, N) add nothing); a chunk's strand s adds float32(c_k) * Y[k] (each
    product rounded, a row with c_k = 0 adding nothing) over its rows s, s +
    S, ... in order; the strands pairwise, (0 + 1) + (2 + 3) ...; the chunk
    partials in chunk order.  Tensors or arrays on the host."""
    Y, idx = _host(Y, idx)
    N, R = Y.shape
    idx = idx[(idx >= 0) & (idx < N)].astype(np.int64)
    c = np.bincount(idx, minlength=N)
    rows = k13_chunk_rows(R)
    S = rows // K13_STEPS
    chunks = -(-N // rows)
    prod = np.zeros((chunks * rows, R), np.float32)
    nz = np.flatnonzero(c)
    prod[nz] = c[nz].astype(np.float32)[:, None] * Y[nz].astype(np.float32)
    v = prod.reshape(chunks, K13_STEPS, S, R)
    acc = np.zeros((chunks, S, R), np.float32)
    for i in range(K13_STEPS):
        acc = acc + v[:, i]
    while acc.shape[1] > 1:
        acc = acc[:, 0::2] + acc[:, 1::2]
    out = np.zeros(R, np.float32)
    for part in acc[:, 0]:
        out = out + part
    return torch.from_numpy(out[None])


@dataclasses.dataclass
class _K13Scratch:
    part: torch.Tensor       # float32 partial rows
    counts: torch.Tensor     # int32 counts, 0 between calls
    ticket: torch.Tensor     # (1,) int32, 0 between calls


_K13_SCRATCH: Dict[Tuple[torch.device, int], _K13Scratch] = {}
# zeroed counts and ticket (n + 1 ints) an eager call leaves for the next
# call captured into a CUDA graph, and those handed out: a graph keeps them
_K13_SPARE: Dict[torch.device, torch.Tensor] = {}
_K13_HELD: List[torch.Tensor] = []


def _k13_scratch(dev: torch.device, stream: int, part: int,
                 n: int) -> _K13Scratch:
    """K13's scratch for a call of ``part`` partial floats and ``n`` counts
    (0 for the gather).  The counts plan leaves its counts and ticket at 0,
    so the eager calls on ``stream``, which run in order, share one, made
    once and grown to a power of two when a call needs more (new counts
    zeroed).  A call captured into a CUDA graph gets its own partials, and
    counts and ticket of its own: the spare an eager call zeroed, never
    handed out again (the graph's pass leaves them at 0 for the next
    replay), or, with no spare as large, zeroed inside the graph (one node
    more).  So no two graphs, nor a graph and the eager calls on its capture
    stream, share them."""
    if torch.cuda.is_current_stream_capturing():
        own = torch.empty(max(part, 1), dtype=torch.float32, device=dev)
        if n == 0:
            return _K13Scratch(own, own[:0].view(torch.int32),
                               own[:0].view(torch.int32))
        spare = _K13_SPARE.pop(dev, None)
        if spare is None or spare.numel() < n + 1:
            spare = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        else:
            _K13_HELD.append(spare)
        return _K13Scratch(own, spare[:n], spare[n:n + 1])
    spare = _K13_SPARE.get(dev)
    if n > 0 and (spare is None or spare.numel() < n + 1):
        _K13_SPARE[dev] = torch.zeros(_pow2(n + 1), dtype=torch.int32,
                                      device=dev)
        torch.cuda.current_stream(dev).synchronize()   # zero before a replay
    key = (dev, stream)
    ws = _K13_SCRATCH.get(key)
    if ws is None:
        ws = _K13Scratch(torch.empty(0, dtype=torch.float32, device=dev),
                         torch.zeros(0, dtype=torch.int32, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev))
        _K13_SCRATCH[key] = ws
    if ws.part.numel() < part:
        ws.part = torch.empty(_pow2(part), dtype=torch.float32, device=dev)
    if ws.counts.numel() < n:
        ws.counts = torch.zeros(_pow2(n), dtype=torch.int32, device=dev)
    return ws


def gather_rowsum(Y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K13: ``out (1, R) = sum_i Y[idx[i], :]`` for float32 Y (N, R), R <=
    256, and int32 indices in [0, N) (not checked on the card), summed in
    float32 in a fixed order: the same bits on every call."""
    return gather_rowsum_with(None, Y, idx)


def gather_rowsum_with(plan: Optional[K13Plan], Y: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """K13 launched with ``plan`` (None: :func:`k13_plan`).  Every counts
    plan gives :func:`gather_rowsum_order`'s bits."""
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
    if plan is None:
        plan = k13_plan(N, M, R)
    elif plan not in k13_plans(N, M, R):
        raise ValueError(f"{plan.describe()} is not a plan of N = {N}")
    stream = _stream(dev)
    if plan.counts:
        grid, tile = k13_grid(N, M, R), 0
        part = -(-N // k13_chunk_rows(R)) * R
    else:
        grid, tile = gather_rowsum_grid(M)
        part = grid * R
    ws = _k13_scratch(dev, stream, part, N if plan.counts else 0)
    out = torch.empty((1, R), dtype=torch.float32, device=dev)
    try:
        k.launch(Y.data_ptr(), idx.data_ptr(), N, M, R, plan.mode, grid,
                 tile, ws.part.data_ptr(), ws.counts.data_ptr(),
                 ws.ticket.data_ptr(), out.data_ptr(), stream)
    except RuntimeError:
        _K13_SCRATCH.pop((dev, stream), None)   # its counts may not be 0
        raise
    return out


# --------------------------------------------------------------------------- #
# K14-K16: HALLaR's inner FISTA step (the loop body of _make_fista)
# --------------------------------------------------------------------------- #


LOOP_KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    Kernel("fista_candidate",
           "ltr_lowrank_sdp_tpu/hallar/solver.py:221-247,198-202,291-318",
           (_I, _I) + (_P,) * 6 + (_I, _D) + (_P,) * 6 + (_I,) * 3 + (_P,),
           typed=True),
    Kernel("al_value",
           "ltr_lowrank_sdp_tpu/hallar/solver.py:208-214,277-284",
           (_I, _I, _I, _P, _P, _P, _P, _I, _D, _D, _D, _P, _P, _P, _P, _P,
            _P, _I, _P),
           typed=True),
    Kernel("fista_commit",
           "ltr_lowrank_sdp_tpu/hallar/solver.py:231-232,239-247",
           (_I, _I) + (_P,) * 15 + (_I, _D, ctypes.c_longlong, _D, _D, _D,
                                   _P, _I, _P),
           typed=True),
)}

FUSED_THREADS = 256       # kThreads in fista_candidate.cu (its two-launch
                          # plan), al_value.cu, fista_commit.cu
FUSED_MAX_BLOCKS = 264    # two blocks an SM of the H100's 132
# the entries of the candidate's scalar vector (fista_candidate's ``sc``)
SC_GD, SC_DD, SC_DNORM, SC_YNORM, SC_WY, SC_WZ, SC_TN = range(7)
SC_LEN = 7

# K14's cluster plan (fista_candidate.cu): kClusterCtas CTAs of
# kClusterThreads threads, the values a thread it is instantiated for, and
# the N above which the two-launch plan takes over
K14_CLUSTER_CTAS = 16
K14_CLUSTER_THREADS = 512
K14_CLUSTER_VALS = (1, 2, 4, 8)
K14_CLUSTER_MAX_N = (K14_CLUSTER_CTAS * K14_CLUSTER_THREADS
                     * K14_CLUSTER_VALS[-1])       # 65,536
# K15 (al_value.cu): kThreads a block, kChunks 16-byte chunks a thread
# loaded before its wait, and the most blocks
K15_THREADS = 256
K15_CHUNKS = 2
K15_MAX_BLOCKS = 528


def loop_counts() -> Dict[str, Tuple[int, int]]:
    """``{name: (launches, plain_calls)}`` of K14-K16."""
    return {k.name: (k.launches, k.plain_calls)
            for k in LOOP_KERNELS.values()}


def fused_blocks(N: int) -> int:
    """The grid of K14's two-launch plan and K16 over ``N`` values: a block
    of ``FUSED_THREADS`` an ``FUSED_THREADS`` values up to
    ``FUSED_MAX_BLOCKS``, the rest taken by stride.  A function of N alone,
    so a sum's order (each thread's strided terms in order, a fixed tree
    over the block, the block partials in block order) and bits do not
    depend on the card."""
    return max(1, min(-(-int(N) // FUSED_THREADS), FUSED_MAX_BLOCKS))


@dataclasses.dataclass(frozen=True)
class K14Plan:
    """K14's launch: ``cluster`` (``K14_CLUSTER_CTAS``) CTAs of one
    thread-block cluster with ``vals`` values a thread (the cluster plan),
    or with ``cluster`` 0 the two-launch plan on ``blocks`` blocks."""

    cluster: int
    vals: int = 0
    blocks: int = 0

    def describe(self) -> str:
        if self.cluster == 0:
            return f"two launches of {self.blocks} blocks"
        return (f"one cluster of {self.cluster} CTAs x "
                f"{K14_CLUSTER_THREADS} threads x {self.vals} values")


def k14_cluster_plan(N: int) -> K14Plan:
    """The cluster plan for N values: the fewest values a thread that hold
    them.  Raises past ``K14_CLUSTER_MAX_N``."""
    per = K14_CLUSTER_CTAS * K14_CLUSTER_THREADS
    for v in K14_CLUSTER_VALS:
        if per * v >= N:
            return K14Plan(K14_CLUSTER_CTAS, v)
    raise ValueError(f"N = {N} exceeds a cluster of {K14_CLUSTER_CTAS} "
                     f"CTAs ({K14_CLUSTER_MAX_N} values)")


def k14_plan(N: int) -> K14Plan:
    """K14's plan for N = n r values, a function of N alone (so are the
    sums' order and bits): the cluster plan up to ``K14_CLUSTER_MAX_N``
    (every value in a register), the two-launch plan above."""
    N = int(N)
    if N > K14_CLUSTER_MAX_N:
        return K14Plan(0, blocks=fused_blocks(N))
    return k14_cluster_plan(N)


def k15_blocks(m: int, dtype: torch.dtype) -> int:
    """K15's grid over m values of ``dtype``: enough ``K15_THREADS``-thread
    blocks for ``K15_CHUNKS`` 16-byte chunks a thread, at most
    ``K15_MAX_BLOCKS`` (the rest taken by stride).  A function of m and the
    value type alone, and so is the sums' order."""
    vec = 16 // (4 if dtype == torch.float32 else 8)
    chunks = -(-int(m) // vec)
    return max(1, min(-(-chunks // (K15_THREADS * K15_CHUNKS)),
                      K15_MAX_BLOCKS))


def _thread_sums(terms: np.ndarray, threads: int, vec: int = 1
                 ) -> np.ndarray:
    """Each of ``threads`` threads' sum of its terms, as K14's cluster plan
    and K15 form it: the terms cut into chunks of ``vec``, chunk c taken by
    thread c mod threads, a thread's chunks in order and a chunk's terms in
    order, added one by one from 0 in the terms' type (the padding past the
    end adds +0, which changes no sum that starts at +0)."""
    dt = terms.dtype
    per = threads * vec
    k = max(1, -(-terms.size // per))
    pad = np.zeros(k * per, dt)
    pad[:terms.size] = terms
    seq = pad.reshape(k, threads, vec).transpose(1, 0, 2).reshape(threads, -1)
    acc = np.zeros(threads, dt)
    for col in seq.T:
        acc = acc + col
    return acc


def _halving(v: np.ndarray) -> np.ndarray:
    """The sum over the last axis (a power of two) by the kernels' xor
    shuffle trees: halves added lane by lane until one is left."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _block_partials(terms: np.ndarray, blocks: int, threads: int,
                    vec: int = 1) -> np.ndarray:
    """The block partials of one sum: the thread sums, the warps' trees,
    then the tree over each block's warp partials."""
    t = _thread_sums(terms, blocks * threads, vec)
    return _halving(_halving(t.reshape(-1, 32)).reshape(blocks, -1))


def _in_order(parts: np.ndarray) -> np.ndarray:
    """Partials added one by one from 0 in their order (K14's CTA partials
    in rank order)."""
    acc = parts.dtype.type(0)
    for x in parts:
        acc = parts.dtype.type(acc + x)
    return acc


def fista_candidate_order(Z, gz, L, Y, tk, W, sqrt_tau: float,
                          plan: Optional[K14Plan] = None):
    """K14's cluster plan (``plan``; None: :func:`k14_plan`, which must be a
    cluster plan) evaluated on the host in its order, bit for bit: the
    elementwise operations of :func:`fista_candidate_plain` one rounding
    each, every sum as :func:`_block_partials` forms a CTA's partial and
    the CTA partials in rank order.  Tensors or arrays on the host; returns
    (Yc, Zn, sc) as tensors."""
    Z, gz, L, Y, tk = _host(Z, gz, L, Y, tk)
    Wh = None if W is None else _host(W)[0]
    shape, dt = Z.shape, Z.dtype
    plan = plan or k14_plan(Z.size)
    if plan.cluster == 0:
        raise ValueError("the two-launch plan has no host order")
    one = dt.type(1)

    def total(terms):
        return _in_order(_block_partials(
            terms.ravel(), plan.cluster, K14_CLUSTER_THREADS))

    z, g, y = Z.ravel(), gz.ravel(), Y.ravel()
    L, tk = dt.type(L), dt.type(tk)
    x = z - g / L
    nrm = np.sqrt(total(x * x))
    scale = min((one / max(nrm, dt.type(1e-30))) * dt.type(sqrt_tau), one)
    tn = dt.type(0.5) * (one + np.sqrt(one + (dt.type(4) * tk) * tk))
    a = (tk - one) / tn
    yc = x * scale
    zn = yc + a * (yc - y)
    d = yc - z
    s = [total(g * d), total(d * d)]
    s += [np.sqrt(s[1]), np.sqrt(total(yc * yc))]
    if Wh is None:
        s += [dt.type(0), dt.type(0)]
    else:
        w = Wh.ravel()
        s += [total((yc - w) * (yc - w)), total((zn - w) * (zn - w))]
    sc = np.array(s + [tn], dt)
    return (torch.from_numpy(yc.reshape(shape)),
            torch.from_numpy(zn.reshape(shape)), torch.from_numpy(sc))


def al_value_order(axc, b, p, beta: float, lam: float, wsq=None):
    """K15 at one point evaluated on the host in its order, bit for bit
    (:func:`k15_blocks`' grid, :func:`_block_partials` over 16-byte chunks,
    the block partials added by lane l = q mod 32 in block order, then the
    warp's tree): the value, as a 0-dim tensor.  The pair's two values are
    this at each point."""
    axc, b, p = _host(axc, b, p)
    dt = axc.dtype
    m = b.size
    vec = 16 // dt.itemsize
    blocks = k15_blocks(m, _torch_dtype(dt))

    def total(terms):
        parts = _block_partials(terms, blocks, K15_THREADS, vec)
        return _halving(_thread_sums(parts, 32))

    r = axc[:m] - b
    v = (axc[m] + total(p * r)) + dt.type(0.5 * beta) * total(r * r)
    if wsq is not None:
        v = dt.type(lam) * v + dt.type(0.5) * dt.type(_host(wsq)[0])
    return torch.tensor(v, dtype=_torch_dtype(dt))


def project_plain(X: torch.Tensor, sqrt_tau: float) -> torch.Tensor:
    """X projected onto the Frobenius ball ||X||_F <= sqrt_tau (the
    reference's ``_Ops.project``, ``ltr_lowrank_sdp_tpu/hallar/solver.py``
    :198-202)."""
    nrm = torch.linalg.vector_norm(X)
    scale = torch.clamp(sqrt_tau / torch.clamp(nrm, min=1e-30), max=1.0)
    return X * scale


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def fista_candidate_plain(Z, gz, L, Y, tk, W, sqrt_tau: float):
    """Plain version of K14: the projected candidate ``Yc = project(Z - gz
    / L)``, the extrapolated point ``Zn = Yc + ((tk - 1) / tn) (Yc - Y)``
    with ``tn = (1 + sqrt(1 + 4 tk^2)) / 2``, and the scalars ``sc`` (SC_*):
    <gz, Yc - Z>, ||Yc - Z||^2, ||Yc - Z||, ||Yc||, and for a prox
    subproblem (``W`` given) ||Yc - W||^2 and ||Zn - W||^2 (else 0), and
    tn.  Returns (Yc, Zn, sc)."""
    Yc = project_plain(Z - gz / L, sqrt_tau)
    diff = Yc - Z
    tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
    Zn = Yc + ((tk - 1.0) / tn) * (Yc - Y)
    parts = [_vdot(gz, diff), _vdot(diff, diff),
             torch.linalg.vector_norm(diff), torch.linalg.vector_norm(Yc)]
    if W is None:
        parts += [torch.zeros((), dtype=Yc.dtype, device=Yc.device)] * 2
    else:
        dy, dz = Yc - W, Zn - W
        parts += [_vdot(dy, dy), _vdot(dz, dz)]
    return Yc, Zn, torch.stack(parts + [tn])


def al_value_plain(axc, b, p, beta: float, lam: float, wsq=None,
                   weights=None):
    """Plain version of K15: with ``axc = [A(YY^T), <C, YY^T>]`` and ``r =
    A(YY^T) - b``, the AL value ``<C, YY^T> + <p, r> + beta/2 <r, r>``, or
    for a prox subproblem (``wsq`` = ||Y - W||^2 given) ``lam`` times it
    plus ``wsq / 2``; with ``weights`` (m + 1,) also writes K6's weights
    ``[p + beta r, 1]`` there."""
    m = b.numel()
    resid = axc[:m] - b
    v = axc[m] + _vdot(p, resid) + 0.5 * beta * _vdot(resid, resid)
    if wsq is not None:
        v = lam * v + 0.5 * wsq
    if weights is not None:
        weights[:m].copy_(p + beta * resid)
        weights[m:].fill_(1.0)
    return v


def fista_commit_plain(Y, Z, gz, tk, L, k, done, fz, Yc, Zn, sc, fy, fzn, S,
                       W, lam: float, maxiter: int, L_inc: float, L0: float,
                       tol: float):
    """Plain version of K16: the backtracking test of the candidate (grow
    when ``fy > fz + <gz, Yc - Z> + L/2 ||Yc - Z||^2 + 1e-12`` and ``L <
    1e12``), and on a commit the FISTA update: Y, Z, tk, L, k, the stop
    test ``L ||Yc - Z|| <= tol (1 + ||Yc||)``, fz and the gradient
    ``2 lam S (+ Zn - W)``, S = (C + A*(w)) Zn; on a grow L times
    ``L_inc``; past ``done`` or ``maxiter`` nothing.  Returns the new (Y,
    Z, gz, tk, L, k, done, fz)."""
    ub = fz + sc[SC_GD] + 0.5 * L * sc[SC_DD]
    grow = (fy > ub + 1e-12) & (L < 1e12)
    go = ~done & (k < maxiter)
    commit = go & ~grow
    grow = go & grow
    crit = L * sc[SC_DNORM]
    stop = crit <= tol * (1.0 + sc[SC_YNORM])
    Ln = torch.clamp(L / L_inc, min=L0)
    gzn = 2.0 * S if W is None else lam * 2.0 * S + (Zn - W)
    return (torch.where(commit, Yc, Y), torch.where(commit, Zn, Z),
            torch.where(commit, gzn, gz), torch.where(commit, sc[SC_TN], tk),
            torch.where(commit, Ln, torch.where(grow, L * L_inc, L)),
            k + commit, torch.where(commit, stop, done),
            torch.where(commit, fzn, fz))


def axc_plain(a_seg: SegCOO, c_rows, c_cols, c_dbl, Y) -> torch.Tensor:
    """Plain version of K5 on HALLaR's union layout of A and C (C's entries
    the segment m): ``[A(YY^T), <C, YY^T>]`` (m + 1,), by K5's and K4's
    plain versions, <C, YY^T> summed in the compute dtype (float32 in K4's
    float32 order) as the reference's ``jnp.sum``."""
    return torch.cat([
        coo_contract_segsum_plain(a_seg, Y, Y),
        sym_contract_sum_plain(c_rows, c_cols, c_dbl, Y, Y,
                               acc32=Y.dtype == torch.float32)[None]])


def _fused_scratch(dev: torch.device, words: int) -> _K4Scratch:
    """K14-K16's partials (``words`` float64 words) and ticket: an eager
    call takes K4's per-stream scratch (eager calls on one stream run in
    order, and every ticket wraps back to 0); a call captured into a CUDA
    graph gets partials of its own and a ticket from the pool of zeroed
    tickets (:func:`_graph_tickets`), so no two graphs, nor a graph and the
    eager calls on its capture stream, share them."""
    if torch.cuda.is_current_stream_capturing():
        return _K4Scratch(
            torch.empty(max(words, 1), dtype=torch.float64, device=dev),
            _graph_tickets(dev))
    return _k4_scratch(dev, _stream(dev), words)


def _scalar(t: torch.Tensor, name: str, dtype, dev) -> None:
    _check(t, name, dtype, (), dev)


def fista_candidate(Z: torch.Tensor, gz: torch.Tensor, L: torch.Tensor,
                    Y: torch.Tensor, tk: torch.Tensor,
                    W: Optional[torch.Tensor], sqrt_tau: float):
    """K14: :func:`fista_candidate_plain`'s (Yc, Zn, sc) as
    :func:`k14_plan` picks from N: one launch of one thread-block cluster
    (the CTAs' partials through distributed shared memory), or above
    ``K14_CLUSTER_MAX_N`` two launches, (a) the sum of squares of Z - gz / L
    and the projection's scale, (b) Yc, Zn and the sums, each by block
    partials and a ticket.  L and tk are read on the card (they change
    between a CUDA graph's replays)."""
    if _is_cpu(Z):
        LOOP_KERNELS["fista_candidate"].plain_calls += 1
        return fista_candidate_plain(Z, gz, L, Y, tk, W, sqrt_tau)
    return fista_candidate_with(None, Z, gz, L, Y, tk, W, sqrt_tau)


def fista_candidate_with(plan: Optional[K14Plan], Z, gz, L, Y, tk, W,
                         sqrt_tau: float):
    """K14 launched with ``plan`` (None: :func:`k14_plan`) on CUDA
    tensors."""
    if _is_cpu(Z):
        raise ValueError("fista_candidate_with launches on CUDA tensors")
    k = LOOP_KERNELS["fista_candidate"]
    dev = Z.device
    dt = _value_dtype(Z, "Z")
    shape = tuple(Z.shape)
    for t, name in ((Z, "Z"), (gz, "gz"), (Y, "Y")) + (
            () if W is None else ((W, "W"),)):
        _check(t, name, dt, shape, dev)
    _scalar(L, "L", dt, dev)
    _scalar(tk, "tk", dt, dev)
    N = _i32(Z.numel(), "n * r")
    plan = plan or k14_plan(N)
    if plan.cluster:
        if (plan.cluster != K14_CLUSTER_CTAS
                or plan.vals not in K14_CLUSTER_VALS
                or plan.cluster * K14_CLUSTER_THREADS * plan.vals < N):
            raise ValueError(f"{plan.describe()} does not hold N = {N}")
        ws, scale = None, None
    else:
        ws = _fused_scratch(dev, 5 * plan.blocks)
        scale = torch.empty((), dtype=dt, device=dev)
    Yc = torch.empty_like(Z)
    Zn = torch.empty_like(Z)
    sc = torch.empty(SC_LEN, dtype=dt, device=dev)
    k.launch(_f32(dt), int(W is not None), Z.data_ptr(), gz.data_ptr(),
             Y.data_ptr(), _ptr(W), L.data_ptr(), tk.data_ptr(), N,
             float(sqrt_tau), _ptr(scale), Yc.data_ptr(), Zn.data_ptr(),
             None if ws is None else ws.part.data_ptr(),
             None if ws is None else ws.ticket.data_ptr(), sc.data_ptr(),
             plan.blocks, plan.cluster, plan.vals, _stream(dev))
    return Yc, Zn, sc


def _al_value_launch(ax, ax2, b, p, beta, lam, wsq, wsq2, weights,
                     npoints: int) -> torch.Tensor:
    k = LOOP_KERNELS["al_value"]
    dev = ax.device
    dt = _value_dtype(ax, "axc")
    m = int(b.numel())
    for t, name in ((ax, "axc"), (ax2, "axc2")):
        if t is not None:
            _check(t, name, dt, (m + 1,), dev)
    _check(b, "b", dt, (m,), dev)
    _check(p, "p", dt, (m,), dev)
    for t, name in ((wsq, "wsq"), (wsq2, "wsq2")):
        if t is not None:
            _scalar(t, name, dt, dev)
    if weights is not None:
        _check(weights, "weights", dt, (m + 1,), dev)
    blocks = k15_blocks(m, dt)
    ws = _fused_scratch(dev, 2 * npoints * blocks)
    out = torch.empty(npoints, dtype=dt, device=dev)
    k.launch(_f32(dt), int(wsq is not None), int(npoints == 2),
             ax.data_ptr(), _ptr(ax2), b.data_ptr(), p.data_ptr(),
             _i32(m, "m"), float(beta), 0.5 * float(beta), float(lam),
             _ptr(wsq), _ptr(wsq2), _ptr(weights), out.data_ptr(),
             ws.part.data_ptr(), ws.ticket.data_ptr(), blocks, _stream(dev))
    return out


def al_value(axc: torch.Tensor, b: torch.Tensor, p: torch.Tensor,
             beta: float, lam: float, wsq: Optional[torch.Tensor] = None,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15 at one point: :func:`al_value_plain` in one launch over the m +
    1 entries of ``axc`` (the sums <p, r> and <r, r> by block partials and
    a ticket); a 0-dim tensor.  ``wsq`` (a prox subproblem's ||Y - W||^2)
    is read on the card.  Launched plainly, after the kernel before it has
    finished, so that kernel may write b or p."""
    if _is_cpu(axc):
        LOOP_KERNELS["al_value"].plain_calls += 1
        return al_value_plain(axc, b, p, beta, lam, wsq, weights)
    return _al_value_launch(axc, None, b, p, beta, lam, wsq, None, weights,
                            1)[0]


def al_value_pair_plain(axc, axc2, b, p, beta: float, lam: float, wsq=None,
                        wsq2=None, weights=None):
    """Plain version of K15's pair: :func:`al_value_plain` at the
    candidate (``axc``, ``wsq``) and then at the extrapolated point
    (``axc2``, ``wsq2``, writing its ``weights``).  Returns (fy, fzn)."""
    return (al_value_plain(axc, b, p, beta, lam, wsq),
            al_value_plain(axc2, b, p, beta, lam, wsq2, weights))


def al_value_pair(axc: torch.Tensor, axc2: torch.Tensor, b: torch.Tensor,
                  p: torch.Tensor, beta: float, lam: float,
                  wsq: Optional[torch.Tensor], wsq2: Optional[torch.Tensor],
                  weights: torch.Tensor):
    """K15 at both points of a machine step in one launch: the values fy at
    the candidate (``axc``) and fzn at the extrapolated point (``axc2``),
    the four sums from one read of b and p, and the second point's K6
    weights.  Launched as a programmatic dependent of the kernel before it
    (K5's reduce): b and p load before its wait, so the kernel launched
    just before the pair on the stream must not write b or p (on the
    machine step it is K5, which writes ``axc2``).  On the CPU the plain
    version, two :func:`al_value_plain` calls (``plain_calls`` counts
    both).  Returns (fy, fzn), 0-dim tensors."""
    if _is_cpu(axc):
        LOOP_KERNELS["al_value"].plain_calls += 2
        return al_value_pair_plain(axc, axc2, b, p, beta, lam, wsq, wsq2,
                                   weights)
    out = _al_value_launch(axc, axc2, b, p, beta, lam, wsq, wsq2, weights,
                           2)
    return out[0], out[1]


def fista_commit(Y, Z, gz, tk, L, k, done, fz, Yc, Zn, sc, fy, fzn, S, W,
                 lam: float, maxiter: int, L_inc: float, L0: float,
                 tol: float):
    """K16: :func:`fista_commit_plain` in one launch, in place on (Y, Z, gz,
    tk, L, k, done, fz), which it returns.  Every block takes the decisions
    from the scalars as they stood before the step and selects its elements;
    only the last block to take the ticket (after every other block has
    read them) writes the scalars."""
    kern = LOOP_KERNELS["fista_commit"]
    if _is_cpu(Y):
        kern.plain_calls += 1
        return fista_commit_plain(Y, Z, gz, tk, L, k, done, fz, Yc, Zn, sc,
                                  fy, fzn, S, W, lam, maxiter, L_inc, L0,
                                  tol)
    dev = Y.device
    dt = _value_dtype(Y, "Y")
    shape = tuple(Y.shape)
    for t, name in ((Y, "Y"), (Z, "Z"), (gz, "gz"), (Yc, "Yc"), (Zn, "Zn"),
                    (S, "S")) + (() if W is None else ((W, "W"),)):
        _check(t, name, dt, shape, dev)
    for t, name in ((tk, "tk"), (L, "L"), (fz, "fz"), (fy, "fy"),
                    (fzn, "fzn")):
        _scalar(t, name, dt, dev)
    _scalar(k, "k", torch.int64, dev)
    _scalar(done, "done", torch.bool, dev)
    _check(sc, "sc", dt, (SC_LEN,), dev)
    N = _i32(Y.numel(), "n * r")
    blocks = fused_blocks(N)
    ws = _fused_scratch(dev, 0)
    kern.launch(_f32(dt), int(W is not None), Y.data_ptr(), Z.data_ptr(),
                gz.data_ptr(), tk.data_ptr(), L.data_ptr(), k.data_ptr(),
                done.data_ptr(), fz.data_ptr(), Yc.data_ptr(), Zn.data_ptr(),
                sc.data_ptr(), fy.data_ptr(), fzn.data_ptr(), S.data_ptr(),
                _ptr(W), N, float(lam) * 2.0, int(maxiter), float(L_inc),
                float(L0), float(tol), ws.ticket.data_ptr(), blocks,
                _stream(dev))
    return Y, Z, gz, tk, L, k, done, fz
