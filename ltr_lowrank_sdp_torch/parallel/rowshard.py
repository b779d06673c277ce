"""The row-sharded mesh mode: each rank owns a share of every SDP cone's
factor rows.

The port of the JAX package's ``mesh_axis="row"`` (``solver/driver.py``
:126-136, the factors placed row-sharded at :169-174 by ``_place_factors``
:190-199), where XLA's GSPMD propagation keeps the elementwise factor
algebra local, turns the scalar contractions into all-reduces and gathers
remote rows only where an operator needs them.  Here each rank is its own
process and does those three things explicitly:

* :class:`RowPartition` (built once on the host, the same on every rank):
  a cone's rows cut into contiguous blocks of the reverse Cuthill-McKee
  order of its objective's graph (K1's ``SymCSR.order``; the problem's own
  order for a dense or empty objective), so that a block's rows are mostly
  one another's neighbours; the blocks' sizes differ by at most one row.
  A rank keeps its rows in the problem's order.  Its *halo* is the rows of
  other ranks that its rows' objective entries reference; its *export* is
  its rows that some other rank's halo holds.
* :class:`RowReduce`, the one reduction point of every sum over factor rows
  (dots, norms, Gram matrices, the constraint vector's norms when it is
  row-sharded).  Each rank forms its partial, the world's partials are
  gathered, and every rank adds them in rank order: every rank holds the
  same bits whatever the collective's own order, and at world size 1 the
  result is the unsharded sum.  A replicated term (the LP cone, a general
  cone's objective value, a replicated constraint vector's dot) enters the
  partial of rank 0 only, so it is added once.  The collective is an
  ``all_reduce`` of a zeroed (world, k) buffer that holds each rank's
  partials in its own slot: an exact gather on gloo and NCCL alike (x + 0
  is x), which gloo also runs on CUDA tensors.
* :class:`RowConeOps` and :class:`RowLPOps`: the operators on a rank's
  rows.  A ``diag_identity`` cone (the MaxCut family: constraint i is row
  i) is local: its constraint vector, dual and CG vectors are row-sharded
  like its factors, K2 and K3 run on the rank's rows, K1 on the rank's
  shard of C (its rows, columns numbered into its rows then its halo) after
  one halo exchange, and K4 sums the objective entries whose row the rank
  owns; a dense objective multiplies the rank's rows of C by the gathered
  factor.  Every other cone (sparse general, dense, an LP cone beside)
  runs its unsharded operators on the all-gathered factor and keeps its own
  output rows: its constraint vector is replicated.

Nothing of a kernel changes: each gets a shard's layout.  At world size 1
every operator is the unsharded one (the rank owns every row in the
problem's order) and every combined sum is its rank's partial, so the
row-sharded solve gives the unsharded solve's bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import torch
import torch.distributed as dist

from ..ops import kernels as K
from ..ops.compsum import cvdot
from ..ops.coneops import ConeOps, LPOps
from ..problem import ConeData


def _sym_pattern(cone: ConeData):
    """Both triangles of the objective's pattern: (rows, cols) with every
    off-diagonal entry twice."""
    rows = np.asarray(cone.c_rows, np.int64)
    cols = np.asarray(cone.c_cols, np.int64)
    off = rows != cols
    return (np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]))


def rcm_order(n: int, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The reverse Cuthill-McKee order of the symmetric pattern (rows,
    cols), as ``SymCSR.from_upper_coo`` computes it for K1; 0 .. n-1 for a
    diagonal or empty pattern."""
    if not (rows != cols).any():
        return np.arange(n)
    g = scipy.sparse.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)),
                                shape=(n, n))
    return scipy.sparse.csgraph.reverse_cuthill_mckee(
        g, symmetric_mode=True).astype(np.int64)


@dataclasses.dataclass
class RowPartition:
    """The rows of one cone of size ``n`` over ``world`` ranks.

    ``owned[s]`` are rank s's rows in ascending order, ``halo[s]`` the
    other ranks' rows its objective entries reference, ``export[s]`` its
    rows that another rank's halo holds (all ascending, global ids);
    ``owner[g]`` and ``local[g]`` are row g's rank and its position there."""

    n: int
    world: int
    owned: List[np.ndarray]
    halo: List[np.ndarray]
    export: List[np.ndarray]
    owner: np.ndarray
    local: np.ndarray

    @staticmethod
    def build(n: int, world: int, rows: Optional[np.ndarray] = None,
              cols: Optional[np.ndarray] = None,
              order: Optional[np.ndarray] = None) -> "RowPartition":
        """Contiguous blocks of ``order`` (default: the RCM order of the
        symmetric pattern (rows, cols), or 0 .. n-1 without one); the halo
        from that pattern (none without one)."""
        if world < 1:
            raise ValueError(f"world size {world}")
        if order is None:
            order = (np.arange(n) if rows is None
                     else rcm_order(n, rows, cols))
        blocks = np.array_split(np.asarray(order, np.int64), world)
        owner = np.empty(n, np.int64)
        local = np.empty(n, np.int64)
        owned = []
        for s, blk in enumerate(blocks):
            own = np.sort(blk)
            owner[own] = s
            local[own] = np.arange(own.size)
            owned.append(own)
        empty = np.zeros(0, np.int64)
        halo = [empty] * world
        export = [empty] * world
        if rows is not None and world > 1:
            cross = owner[rows] != owner[cols]
            r_x, c_x = owner[rows[cross]], cols[cross]
            halo = [np.unique(c_x[r_x == s]) for s in range(world)]
            export = [np.unique(c_x[owner[c_x] == s]) for s in range(world)]
        return RowPartition(n=n, world=world, owned=owned, halo=halo,
                            export=export, owner=owner, local=local)

    @staticmethod
    def for_cone(cone: ConeData, inner: ConeOps, world: int
                 ) -> "RowPartition":
        """A ``diag_identity`` cone with a sparse objective: blocks of K1's
        RCM order and the objective's halo.  Any other cone: blocks of the
        problem's order (its operators gather the whole factor)."""
        if inner.diag_identity and inner.c_csr is not None:
            rows, cols = _sym_pattern(cone)
            order = inner.c_csr.order
            order = (np.arange(cone.n) if order is None
                     else order.cpu().numpy().astype(np.int64))
            return RowPartition.build(cone.n, world, rows, cols, order)
        return RowPartition.build(cone.n, world)

    @property
    def sizes(self) -> List[int]:
        return [int(o.size) for o in self.owned]

    @property
    def max_export(self) -> int:
        return max(int(e.size) for e in self.export)

    def halo_src(self, s: int) -> np.ndarray:
        """Where rank s finds each of its halo rows in the exchanged buffer
        of every rank's export, (world, max_export) flattened."""
        h = self.halo[s]
        t = self.owner[h]
        pos = np.empty(h.size, np.int64)
        for u in np.unique(t):
            sel = t == u
            pos[sel] = np.searchsorted(self.export[u], h[sel])
        return t * self.max_export + pos

    def describe(self) -> str:
        return "; ".join(f"rank {s}: {o.size} owned, {h.size} halo, "
                         f"{e.size} exported"
                         for s, (o, h, e) in enumerate(
                             zip(self.owned, self.halo, self.export)))


class RowReduce:
    """The reduction point of a row-sharded solve over axis ``axis`` of
    ``mesh``, and its gathers.  ``m_sharded``: the constraint vector is
    row-sharded (a single ``diag_identity`` cone), else replicated.
    ``calls`` / ``bytes`` count the collectives it issued and their payload
    on this rank."""

    def __init__(self, mesh, axis: str = "row", m_sharded: bool = False):
        self.group = mesh.group(axis)
        self.world = int(mesh.shape[axis])
        self.rank = int(mesh.coord(axis))
        self.m_sharded = bool(m_sharded)
        self.calls = 0
        self.bytes = 0

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape on every rank), (world, *shape):
        one all-reduce of a zeroed buffer holding ``x`` in this rank's
        slot."""
        buf = x.new_zeros((self.world,) + tuple(x.shape))
        buf[self.rank] = x
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        self.calls += 1
        self.bytes += buf.numel() * buf.element_size()
        return buf

    # ---- sums over rows ------------------------------------------------ #

    def reduce(self, sums: Sequence[torch.Tensor] = (),
               norms: Sequence[torch.Tensor] = ()):
        """One collective: ``(sums, norms)`` combined over the world.  A sum
        is a partial of any shape, added in rank order; a norm is a 0-dim
        local 2-norm, combined as the root of its squares added in rank
        order (at world size 1 the norm itself)."""
        sums, norms = list(sums), list(norms)
        parts = [t.reshape(-1) for t in sums] + [t.reshape(1) for t in norms]
        g = self._gather(torch.cat(parts))
        ns = sum(t.numel() for t in sums)
        tot = g[0, :ns]
        for k in range(1, self.world):
            tot = tot + g[k, :ns]
        if self.world == 1:
            nrm = g[0, ns:]
        else:
            sq = g[0, ns:] * g[0, ns:]
            for k in range(1, self.world):
                sq = sq + g[k, ns:] * g[k, ns:]
            nrm = torch.sqrt(sq)
        out, off = [], 0
        for t in sums:
            out.append(tot[off: off + t.numel()].reshape(t.shape))
            off += t.numel()
        return out, [nrm[i] for i in range(len(norms))]

    def rep(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated sum as this rank's partial: itself on rank 0, zero
        elsewhere."""
        return t if self.rank == 0 else torch.zeros_like(t)

    def own_m(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the constraint vector as this rank's partial: its own
        when the vector is row-sharded, else :meth:`rep`."""
        return t if self.m_sharded else self.rep(t)

    def part_dot(self, x, y, head: Optional[int] = None) -> torch.Tensor:
        """This rank's partial of <x, y> for flat vectors whose first
        ``head`` entries are rows and the rest replicated (the LP factor;
        ``head`` None: all rows)."""
        if head is None or self.rank == 0:
            return torch.dot(x, y)
        return torch.dot(x[:head], y[:head])

    def part_norm(self, x, head: Optional[int] = None) -> torch.Tensor:
        if head is None or self.rank == 0:
            return torch.linalg.vector_norm(x)
        return torch.linalg.vector_norm(x[:head])

    def dot(self, x, y, head: Optional[int] = None) -> torch.Tensor:
        return self.reduce([self.part_dot(x, y, head)])[0][0]

    def norm(self, x, head: Optional[int] = None) -> torch.Tensor:
        return self.reduce((), [self.part_norm(x, head)])[1][0]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A partial of any shape, combined."""
        return self.reduce([t])[0][0]

    def metric_terms(self, obj, b, dual, constr_sum, grams):
        """The metrics' sums in one collective: (<C, X>, b'lambda,
        ||b - A(X)||_2, Grams) from this rank's objective partial and
        Grams, with the solver's expressions (``cvdot``, ``vector_norm``)
        on this rank's share of the constraint vector."""
        (obj, bd, *grams), (rn,) = self.reduce(
            [obj, self.own_m(cvdot(b, dual)), *grams],
            [self.own_m(torch.linalg.vector_norm(b - constr_sum))])
        return obj, bd, rn, grams

    # ---- rows ---------------------------------------------------------- #

    def gather_rows(self, Y: torch.Tensor, part: RowPartition,
                    src: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole (n, ...) tensor, rows in the problem's order, from each
        rank's own rows (one collective); ``src`` the partition's
        :func:`gather_src` on Y's device."""
        if src is None:
            src = gather_src(part, Y.device)
        top = max(part.sizes)
        blk = Y.new_zeros((top,) + tuple(Y.shape[1:]))
        blk[: Y.shape[0]] = Y
        g = self._gather(blk)
        return g.reshape((self.world * top,) + tuple(Y.shape[1:]))[src]


def gather_src(part: RowPartition, device) -> torch.Tensor:
    """Row g of the gathered (world, max owned) buffer, flattened."""
    return torch.tensor(part.owner * max(part.sizes) + part.local,
                        dtype=torch.int64, device=device)


@dataclasses.dataclass
class ShardLayout:
    """Rank ``rank``'s operator data of one ``diag_identity`` cone: its
    rows of the constraint values and, for a sparse objective, its shard of
    C for K1 (its rows; columns numbered into its rows, then its halo rows)
    and its objective entries for K4 (those whose row it owns, in the
    problem's entry order, rows and columns numbered alike); ``export`` the
    positions of the rows it sends, ``halo_src`` where it finds its halo
    rows in the exchange."""

    rank: int
    n_own: int
    n_halo: int
    owned: torch.Tensor            # (n_own,) int64 global rows
    diag_val: torch.Tensor         # (n_own,)
    csr: Optional[K.SymCSR] = None
    k4_rows: Optional[torch.Tensor] = None
    k4_cols: Optional[torch.Tensor] = None
    k4_coef: Optional[torch.Tensor] = None
    export: Optional[torch.Tensor] = None     # (n_export,) local positions
    halo_src: Optional[torch.Tensor] = None   # (n_halo,)
    max_export: int = 0

    @staticmethod
    def build(cone: ConeData, inner: ConeOps, part: RowPartition,
              rank: int) -> "ShardLayout":
        dev, dt = inner.device, inner.dtype
        s = rank
        own = part.owned[s]
        n_own = int(own.size)
        owned_t = torch.tensor(own, dtype=torch.int64, device=dev)
        lay = ShardLayout(rank=s, n_own=n_own, n_halo=int(part.halo[s].size),
                          owned=owned_t, diag_val=inner.diag_val[owned_t],
                          max_export=part.max_export)
        if inner.c_csr is None:
            return lay
        halo = part.halo[s]
        # a global row's id in the shard: its place among the rank's rows,
        # or n_own + its place in the halo
        ext = np.full(part.n, -1, np.int64)
        ext[own] = np.arange(n_own)
        ext[halo] = n_own + np.arange(halo.size)
        # the full CSR's entries in its own order (SymCSR.from_upper_coo:
        # rows ascending, columns ascending in a row), the rank's rows kept
        c = inner.c_csr
        indptr = c.indptr.cpu().numpy().astype(np.int64)
        r_all = np.repeat(np.arange(part.n), np.diff(indptr))
        keep = part.owner[r_all] == s
        c_loc = ext[c.indices.cpu().numpy().astype(np.int64)[keep]]
        lptr = np.zeros(n_own + 1, np.int64)
        np.cumsum(np.bincount(part.local[r_all[keep]], minlength=n_own),
                  out=lptr[1:])
        order = None
        if c.order is not None:
            full = c.order.cpu().numpy().astype(np.int64)
            order = torch.tensor(part.local[full[part.owner[full] == s]],
                                 dtype=torch.int32, device=dev)
        lay.csr = K.SymCSR(
            n=n_own,
            indptr=torch.tensor(lptr, dtype=torch.int32, device=dev),
            indices=torch.tensor(c_loc, dtype=torch.int32, device=dev),
            vals=c.vals[torch.tensor(np.flatnonzero(keep), device=dev)],
            order=order)
        rows = np.asarray(cone.c_rows, np.int64)
        cols = np.asarray(cone.c_cols, np.int64)
        mine = np.flatnonzero(part.owner[rows] == s)
        mine_t = torch.tensor(mine, dtype=torch.int64, device=dev)
        lay.k4_rows = torch.tensor(ext[rows[mine]], dtype=torch.int32,
                                   device=dev)
        lay.k4_cols = torch.tensor(ext[cols[mine]], dtype=torch.int32,
                                   device=dev)
        lay.k4_coef = inner.c_double_coef[mine_t]
        lay.export = torch.tensor(part.local[part.export[s]],
                                  dtype=torch.int64, device=dev)
        lay.halo_src = torch.tensor(part.halo_src(s), dtype=torch.int64,
                                    device=dev)
        return lay

    def extend(self, Y: torch.Tensor, halo_rows: torch.Tensor
               ) -> torch.Tensor:
        """Y's rows then its halo rows."""
        if self.n_halo == 0:
            return Y
        return torch.cat([Y, halo_rows])

    def halo_from_full(self, Y_full: torch.Tensor, part: RowPartition
                       ) -> torch.Tensor:
        """The halo rows taken from a whole factor (no exchange: the tests'
        and the smoke run's check of one rank's layout in one process)."""
        idx = torch.tensor(part.halo[self.rank], dtype=torch.int64,
                           device=Y_full.device)
        return Y_full[idx]


class RowConeOps:
    """A :class:`~..ops.coneops.ConeOps` on this rank's rows of one cone;
    ``inner`` (the unsharded operators, built on every rank) serves the
    gathered paths.  ``n`` stays the cone's size (the Lanczos depth and the
    flop counts derive from it); ``n_local`` is this rank's rows and ``m``
    the length of this rank's constraint vector."""

    def __init__(self, cone: ConeData, inner: ConeOps, part: RowPartition,
                 red: RowReduce):
        self.inner, self.part, self.red = inner, part, red
        for name in ("n", "device", "dtype", "c_nnz", "kind_a", "kind_c",
                     "n_active", "rank_max", "diag_identity"):
            setattr(self, name, getattr(inner, name))
        s = red.rank
        self.n_local = part.sizes[s]
        self.owned = torch.tensor(part.owned[s], dtype=torch.int64,
                                  device=self.device)
        self.src = gather_src(part, self.device)
        self.local = inner.diag_identity
        self.m = self.n_local if self.local else inner.m
        self.layout = None
        self.c_own = None
        if self.local:
            self.layout = ShardLayout.build(cone, inner, part, s)
            self.diag_val = self.layout.diag_val
            if inner.c_dense is not None:
                self.c_own = inner.c_dense[self.owned]
        else:
            self.diag_val = inner.diag_val

    # ---- exchanges ----------------------------------------------------- #

    def gather(self, Y: torch.Tensor) -> torch.Tensor:
        """The whole factor from every rank's rows (one collective)."""
        return self.red.gather_rows(Y, self.part, self.src)

    def ext(self, Y: torch.Tensor) -> torch.Tensor:
        """Y's rows then its halo rows (one collective, none when no rank
        has a halo)."""
        lay = self.layout
        if lay.max_export == 0:
            return Y
        out = Y.new_zeros((lay.max_export,) + tuple(Y.shape[1:]))
        out[: lay.export.numel()] = Y[lay.export]
        g = self.red._gather(out)
        halo = g.reshape((-1,) + tuple(Y.shape[1:]))[lay.halo_src]
        return lay.extend(Y, halo)

    def _both(self, U, V):
        gu = self.gather(U)
        return gu, (gu if V is U else self.gather(V))

    # ---- constraints --------------------------------------------------- #

    def constr_vals(self, U, V):
        if self.local:
            return K.diag_rowdot(U, V, self.diag_val, 1.0)
        return self.inner.constr_vals(*self._both(U, V))

    def constr_vals_pair(self, R, D):
        if self.local:
            return K.diag_rowdot(R, D, self.diag_val, 2.0, second=True)
        return self.inner.constr_vals_pair(self.gather(R), self.gather(D))

    def cg_normal_matvec(self, fixed):
        if self.local:
            dv = self.diag_val
            return lambda x: K.diag_normal_matvec(x, fixed, dv)
        mv = self.inner.cg_normal_matvec(self.gather(fixed))
        return lambda x: mv(self.gather(x))[self.owned]

    def apply_a(self, w, Y):
        if self.local:
            return K.spmm_sym_csr(None, Y, 0.0, d=self.diag_val, w=w)
        return self.inner.apply_a(w, self.gather(Y))[self.owned]

    # ---- objective ----------------------------------------------------- #

    def apply_c(self, Y):
        if not self.local:
            return self.inner.apply_c(self.gather(Y))[self.owned]
        if self.c_own is not None:
            return torch.matmul(self.c_own, self.gather(Y))
        if self.layout.csr is None:
            return torch.zeros_like(Y)
        return K.spmm_sym_csr(self.layout.csr, self.ext(Y), 1.0)

    def apply_w(self, w, Y, obj_coef=1.0, include_obj=True):
        if not self.local:
            return self.inner.apply_w(w, self.gather(Y), obj_coef=obj_coef,
                                      include_obj=include_obj)[self.owned]
        if not (include_obj and self.c_nnz):
            return self.apply_a(w, Y)
        if self.c_own is not None:
            cy = float(obj_coef) * torch.matmul(self.c_own, self.gather(Y))
            return self.apply_a(w, Y) + cy
        return K.spmm_sym_csr(self.layout.csr, self.ext(Y), float(obj_coef),
                              d=self.diag_val, w=w)

    def obj_value(self, U, V):
        """This rank's partial of <C, sym(U V^T)>: the entries of its rows
        (a local cone), or the whole value on rank 0 (a gathered one)."""
        if not self.c_nnz:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        if not self.local:
            return self.red.rep(self.inner.obj_value(*self._both(U, V)))
        if self.c_own is not None:
            gu, gv = self._both(U, V)
            uv = cvdot(U, torch.matmul(self.c_own, gv))
            if U is V:
                return uv
            return 0.5 * (uv + cvdot(V, torch.matmul(self.c_own, gu)))
        lay = self.layout
        ue = self.ext(U)
        ve = ue if V is U else self.ext(V)
        return K.sym_contract_sum(lay.k4_rows, lay.k4_cols, lay.k4_coef,
                                  ue, ve).to(self.dtype)

    def constr_flops(self, rank: int) -> int:
        return self.inner.constr_flops(rank)

    def apply_flops(self, rank: int) -> int:
        return self.inner.apply_flops(rank)


class RowLPOps:
    """The LP cone in a row-sharded solve: replicated on every rank, its
    objective value entering rank 0's partial only."""

    def __init__(self, inner: LPOps, red: RowReduce):
        self.inner, self.red = inner, red

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def obj_value(self, u, v):
        return self.red.rep(self.inner.obj_value(u, v))


def pad_rows(F: torch.Tensor, new_rank: int, n: int,
             rows: torch.Tensor) -> torch.Tensor:
    """``common.pad_rank_columns`` on a rank's rows ``rows`` (global ids)
    of an n-row factor: the scaled identity block lands on the rows it
    holds."""
    old = F.shape[1]
    aug = new_rank - old
    if aug <= 0:
        return F
    r = min(n, aug)
    pad = torch.zeros((F.shape[0], aug), dtype=F.dtype, device=F.device)
    pos = torch.nonzero(rows < r).reshape(-1)
    pad[pos, rows[pos]] = float(1.0 / np.sqrt(r))
    return torch.cat([F, pad], dim=1)
