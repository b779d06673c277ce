"""Instance generators -> SDPA sparse files.

The port's copy of the repository's ``scripts/gen_instances.py``: the same
generators, subcommands and flags, and for the same arguments byte-identical
files.  numpy only: it runs no device work.

    python -m ltr_lowrank_sdp_torch.scripts.gen_instances maxcut --n 3200 \\
        --avg-degree 14 --out dataset/instances/maxcut_n3200_d14.dat-s

Python equivalents of the reference Julia generators:

* MaxCut (``lorads/data/gen_MaxCut.jl:213-243``): objective L/4 from a graph
  adjacency, constraints diag(X) = e;
* MatrixCompletion (``lorads/data/gen_MatrixCompletion.jl:261-276``): seeded
  random rank-3 ground truth M = LR^T, observed entries as constraints on
  the symmetric embedding [[W1, X],[X^T, W2]], objective tr(W1)+tr(W2)
  (nuclear-norm minimization).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def write_sdpa(path, n_blocks_dims, b, entries):
    """entries: list of (constr_id(0=obj), block(1-based), i, j, val) with
    1-based i<=j."""
    with open(path, "w") as f:
        f.write(f"{len(b)}\n{len(n_blocks_dims)}\n")
        f.write(" ".join(str(d) for d in n_blocks_dims) + "\n")
        f.write(" ".join(f"{x:.16g}" for x in b) + "\n")
        for c, blk, i, j, v in entries:
            f.write(f"{c} {blk} {i} {j} {v:.16g}\n")


def gen_maxcut(n: int, avg_degree: int, seed: int, out: str):
    rng = np.random.default_rng(seed)
    m_edges = n * avg_degree // 2
    u = rng.integers(0, n, size=m_edges)
    v = rng.integers(0, n, size=m_edges)
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = (uniq // n).astype(int), (uniq % n).astype(int)
    w = np.ones(lo.size)
    deg = np.zeros(n)
    np.add.at(deg, lo, w)
    np.add.at(deg, hi, w)

    # SDPA convention: the written objective F0 is MAXIMIZED; the solver
    # minimizes -F0.  MaxCut SDP: max <L/4, X>  ->  write L/4.
    entries = []
    for i in range(n):
        if deg[i]:
            entries.append((0, 1, i + 1, i + 1, deg[i] / 4.0))
    for a, bb, ww in zip(lo, hi, w):
        entries.append((0, 1, a + 1, bb + 1, -ww / 4.0))
    for i in range(n):
        entries.append((i + 1, 1, i + 1, i + 1, 1.0))
    write_sdpa(out, [n], np.ones(n), entries)


def gen_theta(n: int, avg_degree: int, seed: int, out: str):
    """Lovász theta SDP of a random G(n, avg_degree) graph.

    max <J, X>  s.t.  tr X = 1,  X_ij = 0 for (i,j) in E,  X >= 0 —
    the theta102/theta12 family shape (one dense-coupled trace
    constraint + one sparse equality per edge; cf.
    ``lorads/README.md:260-261``).  SDPA convention: F0 is maximized.
    """
    rng = np.random.default_rng(seed)
    m_edges = n * avg_degree // 2
    u = rng.integers(0, n, size=m_edges)
    v = rng.integers(0, n, size=m_edges)
    keep = u != v
    u, v = u[keep], v[keep]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    uniq = np.unique(lo.astype(np.int64) * n + hi)
    lo, hi = (uniq // n).astype(int), (uniq % n).astype(int)

    entries = []
    # objective J (all-ones): upper triangle incl. diagonal
    for i in range(n):
        for j in range(i, n):
            entries.append((0, 1, i + 1, j + 1, 1.0))
    # constraint 1: trace(X) = 1
    for i in range(n):
        entries.append((1, 1, i + 1, i + 1, 1.0))
    # constraints 2..: X_ij = 0 per edge
    b = [1.0]
    for k, (a, bb) in enumerate(zip(lo, hi)):
        entries.append((k + 2, 1, int(a) + 1, int(bb) + 1, 1.0))
        b.append(0.0)
    write_sdpa(out, [n], np.asarray(b), entries)


def gen_matcomp(n1: int, n2: int, rank: int, sample_factor: float, seed: int,
                out: str):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n1, rank))
    R = rng.normal(size=(n2, rank))
    n_obs = int(sample_factor * rank * (n1 + n2) * np.log(n1 + n2))
    n_obs = min(n_obs, n1 * n2)
    idx = rng.choice(n1 * n2, size=n_obs, replace=False)
    ii, jj = (idx // n2).astype(int), (idx % n2).astype(int)
    vals = np.einsum("ij,ij->i", L[ii], R[jj])

    n = n1 + n2
    entries = []
    # objective: minimize tr(W1) + tr(W2) -> F0 = -I (SDPA maximizes F0)
    for k in range(n):
        entries.append((0, 1, k + 1, k + 1, -1.0))
    b = []
    for c, (i, j, v) in enumerate(zip(ii, jj, vals), start=1):
        # X block entry (i, n1 + j): <A, Y> = 2 * Y[i, n1+j] = 2 * X_ij = 2v
        entries.append((c, 1, i + 1, n1 + j + 1, 1.0))
        b.append(2.0 * v)
    write_sdpa(out, [n], np.array(b), entries)


def main(argv=None):
    ap = argparse.ArgumentParser(description="generate SDP instances")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mc = sub.add_parser("maxcut")
    mc.add_argument("--n", type=int, default=1000)
    mc.add_argument("--avg-degree", type=int, default=6)
    mc.add_argument("--seed", type=int, default=0)
    mc.add_argument("--out", required=True)
    th = sub.add_parser("theta")
    th.add_argument("--n", type=int, default=120)
    th.add_argument("--avg-degree", type=int, default=40)
    th.add_argument("--seed", type=int, default=0)
    th.add_argument("--out", required=True)

    mp = sub.add_parser("matcomp")
    mp.add_argument("--n1", type=int, default=500)
    mp.add_argument("--n2", type=int, default=500)
    mp.add_argument("--rank", type=int, default=3)
    mp.add_argument("--sample-factor", type=float, default=2.0)
    mp.add_argument("--seed", type=int, default=0)
    mp.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.cmd == "maxcut":
        gen_maxcut(args.n, args.avg_degree, args.seed, args.out)
    elif args.cmd == "theta":
        gen_theta(args.n, args.avg_degree, args.seed, args.out)
    else:
        gen_matcomp(args.n1, args.n2, args.rank, args.sample_factor,
                    args.seed, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
