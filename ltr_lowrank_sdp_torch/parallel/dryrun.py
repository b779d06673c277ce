"""Run the parallel modes once over a fresh ``torch.distributed`` world.

The twin of ``__graft_entry__.dryrun_multichip`` (``:56-166``):

    python -m ltr_lowrank_sdp_torch.parallel.dryrun --world-size N \\
        [--backend gloo|nccl] [--device cpu]

starts N ranks (:func:`.launch.spawn`), lays them out as a (batch, constr)
mesh the way the JAX dry run factors its devices (the first of 2, 4, 8 that
divides N on the batch axis), and runs on every rank the constraint-sharded
production solve of ``random_maxcut_problem(48, 5, seed=1)`` (axis 1), the
row-sharded solve of ``random_maxcut_problem(16 N, 5, seed=2)`` over all N
ranks (axis 1b, ``mesh_axis="row"``: each rank holds its share of the
factor rows) and three batched ALM steps (axis 2).  Ranks run on the GPU
(``cuda:<rank % device count>``) unless ``--device cpu``; gloo all-reduces
CUDA tensors through the host, so two ranks can share one card, where NCCL
refuses to.  A rank that fails makes the command exit nonzero.

:func:`sharded_solve`, :func:`row_solve` and :func:`batched_steps` are the
rank functions of one constraint-sharded solve, one row-sharded solve and
one run of batched steps, for callers that compare them with their
unsharded versions.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SolverParams
from ..ops import kernels as K
from ..solver.driver import Solver
from ..testing import random_maxcut_problem
from .batch import BatchedMaxCutProblem, batched_alm_steps
from .launch import spawn
from .mesh import make_mesh


def _batch_axis(world_size: int) -> int:
    for cand in (2, 4, 8):
        if world_size % cand == 0:
            return cand
    return 1


def sharded_solve(prob, params: SolverParams,
                  device: Optional[str] = None) -> dict:
    """On one rank, on its card (or ``device``): the solve of ``prob`` with
    every cone constraint-sharded over the whole world, the launch counters
    set to 0 just before and read just after.  Returns the result's numbers
    as plain Python values, the operators' all-reduces (calls, bytes) and
    the stop decisions' (``Mesh.agree``)."""
    mesh = make_mesh(device=device)
    solver = Solver(prob, params, mesh=mesh)
    K.reset_counts()
    res = solver.solve()
    return {
        "rank": mesh.rank, "mesh": dict(mesh.shape),
        "device": str(mesh.device), "status": res.status.value,
        "pobj": res.pobj, "dobj": res.dobj, "pinf_l1": res.pinf_l1,
        "gap": res.gap, "dinf_l1": res.dinf_l1,
        "alm_outer_iters": res.alm_outer_iters,
        "alm_inner_iters": res.alm_inner_iters,
        "admm_iters": res.admm_iters, "cg_iters": res.cg_iters,
        "final_ranks": res.final_ranks, "host_syncs": res.host_syncs,
        "solve_time": res.solve_time,
        "allreduce_calls": sum(c.allreduce_calls for c in solver.cones),
        "allreduce_bytes": sum(c.allreduce_bytes for c in solver.cones),
        "agree_calls": mesh.agree_calls,
        "counts": K.counts(), "sharded": [c.sharded for c in solver.cones]}


def row_solve(prob, params: SolverParams, device: Optional[str] = None,
              init_factors=None, lanczos_start=None,
              factors: bool = False) -> dict:
    """On one rank: the solve of ``prob`` with every cone's factor rows
    sharded over the whole world (``mesh_axis="row"``), the launch
    counters set to 0 just before and read just after.  Returns the
    result's numbers as plain Python values, the partitions and the
    collectives this rank issued (and with ``factors`` the gathered U, V,
    the dual and the objective scale, for a host check)."""
    mesh = make_mesh(axis_names=("batch", "row"), device=device)
    solver = Solver(prob, params, mesh=mesh, mesh_axis="row")
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    K.reset_counts()
    res = solver.solve(init_factors=init_factors,
                       lanczos_start=lanczos_start)
    out = {
        "rank": mesh.rank, "world": mesh.shape["row"],
        "device": str(mesh.device), "status": res.status.value,
        "pobj": res.pobj, "dobj": res.dobj, "pinf_l1": res.pinf_l1,
        "gap": res.gap, "dinf_l1": res.dinf_l1,
        "counts": (res.alm_outer_iters, res.alm_inner_iters,
                   res.admm_iters, res.cg_iters),
        "final_ranks": res.final_ranks, "host_syncs": res.host_syncs,
        "solve_time": res.solve_time, "stage_times": res.stage_times,
        "collectives": solver.red.calls,
        "collective_bytes": solver.red.bytes,
        "agree_calls": mesh.agree_calls,
        "rows": [ops.n_local for ops in solver.cones],
        "partitions": [p.describe() for p in solver.row_parts],
        "kernels": K.counts()}
    if mesh.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    if factors:
        out.update(U=res.U, V=res.V, dual=res.dual, obj_scale=res.obj_scale)
    return out


def batched_steps(prob: BatchedMaxCutProblem, R, dual, rho: float,
                  num_steps: int, batch: int,
                  device: Optional[str] = None) -> dict:
    """On one rank, on its card (or ``device``): ``batched_alm_steps`` over
    a mesh of the world with ``batch`` on the batch axis, the launch
    counters set to 0 just before and read just after, timed to a
    synchronize."""
    mesh = make_mesh(batch=batch, device=device)
    K.reset_counts()
    t = time.perf_counter()
    out = batched_alm_steps(mesh, prob, R, dual, rho, num_steps)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t
    return {"rank": mesh.rank, "mesh": dict(mesh.shape),
            "device": str(mesh.device), "wall": wall, "counts": K.counts(),
            "R": out[0].cpu().numpy(), "dual": out[1].cpu().numpy(),
            "pinf": out[2].cpu().numpy()}


def _dryrun_rank(world_size: int, device: Optional[str]) -> dict:
    batch_axis = _batch_axis(world_size)
    mesh = make_mesh(batch=batch_axis, device=device)
    dtype = torch.float64

    # ---- the constraint-sharded production solve ----
    prob = random_maxcut_problem(48, avg_degree=5, seed=1)
    params = SolverParams(dtype="float64", disable_oracle=True)
    res = Solver(prob, params, mesh=mesh).solve()
    if not res.errors_ok:
        raise RuntimeError(f"sharded production solve failed: "
                           f"{res.status.value}")

    # ---- the row-sharded production solve over every rank ----
    row = row_solve(random_maxcut_problem(16 * world_size, avg_degree=5,
                                          seed=2), params, device=device)
    if row["status"] not in ("primal_dual_optimal", "primal_optimal"):
        raise RuntimeError(f"row-sharded production solve failed: "
                           f"{row['status']}")

    # ---- the batched instances over the batch axis ----
    B = max(batch_axis, 2)
    rng = np.random.default_rng(0)
    n, r, nnz = 32, 4, 64
    rows = rng.integers(0, n, size=(B, nnz))
    cols = np.maximum(rows, rng.integers(0, n, size=(B, nnz)))
    bprob = BatchedMaxCutProblem(
        c_rows=torch.tensor(rows), c_cols=torch.tensor(cols),
        c_vals=torch.tensor(rng.normal(size=(B, nnz)), dtype=dtype),
        b=torch.ones((B, n), dtype=dtype), n=n)
    steps = 0
    if B % batch_axis == 0:
        R = torch.tensor(rng.normal(size=(B, n, r)), dtype=dtype)
        dual = torch.zeros((B, n), dtype=dtype)
        _, _, pinf = batched_alm_steps(mesh, bprob, R, dual, 1.0,
                                       num_steps=3)
        if tuple(pinf.shape) != (B,):
            raise RuntimeError(f"batched steps: pinf shape {pinf.shape}")
        steps = 3
    return {"rank": mesh.rank, "mesh": dict(mesh.shape),
            "device": str(mesh.device), "status": res.status.value,
            "pobj": res.pobj, "batched_steps": steps, "row": row}


def dryrun(world_size: int, backend: str = "gloo",
           device: Optional[str] = None) -> str:
    """Run the dry run on ``world_size`` ranks; returns its one line."""
    results = spawn(_dryrun_rank, world_size, (world_size, device),
                    backend=backend)
    pobjs = {r["pobj"] for r in results}
    if len(pobjs) != 1:
        raise RuntimeError(f"the ranks' sharded solves differ: {pobjs}")
    row_pobjs = {r["row"]["pobj"] for r in results}
    if len(row_pobjs) != 1:
        raise RuntimeError(f"the ranks' row-sharded solves differ: "
                           f"{row_pobjs}")
    mesh = results[0]["mesh"]
    row = results[0]["row"]
    return (f"dryrun_multichip OK on {world_size} ranks ({backend}, "
            f"{results[0]['device']}; mesh batch={mesh['batch']} "
            f"constr={mesh['constr']}; sharded solve "
            f"{results[0]['status']} pobj {results[0]['pobj']:.12e}; "
            f"row-sharded solve (n = {16 * world_size}; "
            f"{row['partitions'][0]}) {row['status']} "
            f"pobj {row['pobj']:.12e}; "
            f"{results[0]['batched_steps']} batched ALM steps)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the GPU)")
    args = ap.parse_args(argv)
    print(dryrun(args.world_size, args.backend, args.device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
