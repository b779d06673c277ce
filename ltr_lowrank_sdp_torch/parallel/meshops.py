"""Constraint-sharded conic operators for the production solver phases.

The port of ``ltr_lowrank_sdp_tpu/parallel/meshops.py`` (row 16 of the
kernel table: ``_local_reduce`` :211 and ``_local_spmm`` :220 with their
``psum``).  The two hot operators of the solver, ``A(sym(U V^T))`` and
``A*(w) Y``, run on each rank over its own share of the cone's constraint
entries and end in one ``all_reduce`` over the mesh axis:

* ``constr_vals``: each rank owns the contiguous constraint range that
  :func:`_partition_by_id` gives it, runs K5 (``coo_contract_segsum``) on
  those constraints' entries and writes the result into its range of a
  zeroed (m,) vector;
* ``apply_a``: each rank owns a contiguous range of output rows over the
  symmetrized slots and runs K6 (``spmm_constr_csr``) on a ``ConstrCSR``
  that keeps only those rows (the others are empty and write 0).

One owner per output and exact zeros from every other rank make the summed
result independent of the rank count, bit for bit, and equal on every rank:
the solver's replicated control flow depends on that (``Solver``).

Boundary contract, as in the JAX package: factors and (m,) vectors enter
and leave replicated, so a :class:`MeshConeOps` is a drop-in for
:class:`~..ops.coneops.ConeOps` and the phases do not change.  Dense-A cones
and cones with no constraint entry are not sharded (they delegate to the
wrapped ``ConeOps``), nor are the cold paths (objective value, C @ Y, flop
counts).  ``constr_vals_pair`` is three sharded ``constr_vals`` calls and
``cg_normal_matvec`` is composed from the sharded operators, as the JAX
package's sharded path does (they round apart from the unsharded fused
versions).  The JAX package's shard-uniform bucketed-ELL tables
(``build_shard_tables``) are not ported: their padding serves
``shard_map``'s single traced program and the TPU's scatter cost; a rank's
own segment and CSR slice compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernels as K
from ..ops.coneops import ConeOps
from ..problem import ConeData


def _partition_by_id(ids: np.ndarray, n_out: int, D: int):
    """Contiguous output-id ranges per shard, balanced by slot count (a copy
    of the JAX package's ``meshops._partition_by_id``).

    Returns (ranges, owner) with ranges[s] = (lo, hi) and owner[slot] =
    shard index.  A range may be empty."""
    counts = np.bincount(ids, minlength=n_out).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(counts)])
    total = csum[-1]
    bounds = [0]
    for s in range(1, D):
        target = total * s // D
        bounds.append(int(np.searchsorted(csum, target)))
    bounds.append(n_out)
    bounds = np.maximum.accumulate(np.asarray(bounds))
    ranges = [(int(bounds[s]), int(bounds[s + 1])) for s in range(D)]
    owner_of_id = np.zeros(n_out, np.int64)
    for s, (lo, hi) in enumerate(ranges):
        owner_of_id[lo:hi] = s
    return ranges, owner_of_id[ids]


def _cone_entries(cone: ConeData, inner: ConeOps):
    """(rows, cols, vals, cid) of the cone's constraint entries in the
    solver's internal constraint order (under ``diag_identity`` constraint
    i is row i)."""
    if inner.diag_identity:
        rows = np.arange(inner.n)
        vals = inner.diag_val.double().cpu().numpy()
        return rows, rows, vals, rows
    if cone.kind_a == "diag":
        rows = np.asarray(cone.diag_idx, np.int64)
        return (rows, rows, np.asarray(cone.diag_val, np.float64),
                np.asarray(cone.diag_cid, np.int64))
    return (np.asarray(cone.a_rows, np.int64),
            np.asarray(cone.a_cols, np.int64),
            np.asarray(cone.a_vals, np.float64),
            np.asarray(cone.a_cid, np.int64))


class MeshConeOps:
    """Drop-in :class:`~..ops.coneops.ConeOps` with its two hot operators
    sharded over axis ``axis`` of ``mesh``; ``inner`` (the unsharded
    operators of the same cone) serves everything else."""

    def __init__(self, cone: ConeData, inner: ConeOps, mesh,
                 axis: str = "constr", dtype=None):
        if dtype is not None and dtype != inner.dtype:
            raise TypeError(f"dtype {dtype} is not the inner operators' "
                            f"{inner.dtype}")
        self.inner = inner
        self.mesh = mesh
        self.axis = axis
        for name in ("n", "m", "device", "dtype", "c_nnz"):
            setattr(self, name, getattr(inner, name))
        self.D = mesh.shape[axis]
        self.group = mesh.group(axis)
        self.allreduce_calls = 0      # all-reduces this cone's ops issued
        self.allreduce_bytes = 0      # and their payload on this rank

        self.sharded = inner.kind_a != "dense"
        if self.sharded and inner.kind_a != "diag" and inner.a_seg is None:
            self.sharded = False
        if not self.sharded:
            return
        rows, cols, vals, cid = _cone_entries(cone, inner)
        s = mesh.coord(axis)

        # (1) the constraint-value reduction, sharded by constraint id
        lo, hi = _partition_by_id(cid, self.m, self.D)[0][s]
        self.cv_range = (lo, hi)
        own = (cid >= lo) & (cid < hi)
        self.cv_seg = (K.SegCOO.from_coo(rows[own], cols[own], vals[own],
                                         cid[own] - lo, self.n, hi - lo,
                                         self.device, self.dtype)
                       if hi > lo else None)
        # (2) the adjoint SpMM, sharded by output row over the symmetrized
        # slots
        off = rows != cols
        s_rows = np.concatenate([rows, cols[off]])
        lo, hi = _partition_by_id(s_rows, self.n, self.D)[0][s]
        self.mm_range = (lo, hi)
        self.mm_csr = (K.ConstrCSR.from_upper_coo(
            rows, cols, vals, cid, self.n, self.m, self.device, self.dtype,
            row_range=(lo, hi)) if hi > lo else None)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        self.allreduce_calls += 1
        self.allreduce_bytes += t.numel() * t.element_size()
        return t

    # ---- hot ops ------------------------------------------------------ #

    def constr_vals(self, U, V):
        if not self.sharded:
            return self.inner.constr_vals(U, V)
        out = torch.zeros(self.m, dtype=self.dtype, device=self.device)
        if self.cv_seg is not None:
            lo, hi = self.cv_range
            out[lo:hi] = K.coo_contract_segsum(self.cv_seg, U, V)
        return self._all_reduce(out)

    def constr_vals_pair(self, R, D):
        """(A(2 sym(R D^T)), A(D D^T)) as three sharded ``constr_vals``."""
        if not self.sharded:
            return self.inner.constr_vals_pair(R, D)
        rd = self.constr_vals(R, D)
        dr = self.constr_vals(D, R)
        dd = self.constr_vals(D, D)
        return rd + dr, dd

    def cg_normal_matvec(self, fixed):
        """``x -> x + A*(A(sym(x fixed^T))) fixed`` from the sharded
        operators."""
        if not self.sharded:
            return self.inner.cg_normal_matvec(fixed)

        def mv(x):
            return x + self.apply_a(self.constr_vals(x, fixed), fixed)

        return mv

    def apply_a(self, w, Y):
        if not self.sharded:
            return self.inner.apply_a(w, Y)
        if self.mm_csr is None:
            out = torch.zeros_like(Y)
        else:
            out = K.spmm_constr_csr(self.mm_csr, w, Y)
        return self._all_reduce(out)

    def apply_w(self, w, Y, obj_coef=1.0, include_obj=True):
        if not self.sharded:
            return self.inner.apply_w(w, Y, obj_coef=obj_coef,
                                      include_obj=include_obj)
        out = self.apply_a(w, Y)
        if include_obj and self.c_nnz:
            out = out + float(obj_coef) * self.inner.apply_c(Y)
        return out

    # ---- cold paths (replicated) -------------------------------------- #

    def obj_value(self, U, V):
        return self.inner.obj_value(U, V)

    def apply_c(self, Y):
        return self.inner.apply_c(Y)

    def constr_flops(self, rank: int) -> int:
        return self.inner.constr_flops(rank)

    def apply_flops(self, rank: int) -> int:
        return self.inner.apply_flops(rank)

    @property
    def diag_identity(self):
        return self.inner.diag_identity

    @property
    def diag_val(self):
        return self.inner.diag_val
