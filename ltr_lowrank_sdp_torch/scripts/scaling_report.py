"""Scaling report of the sharded solver on 1, 2, 4 ... cards.

The twin of the repository's ``scripts/scaling_report.py`` (:32-82), which
times the JAX package's constraint-sharded solver on a virtual CPU mesh.
Here every world size is a fresh ``torch.distributed`` world of real ranks
(:func:`..parallel.launch.spawn`), one rank a card over NCCL:

    python -m ltr_lowrank_sdp_torch.scripts.scaling_report \\
        [--devices 1,2,4] [--axis constr|row] [--delaunay K] \\
        [--device cpu] [--out PATH]

Per world size N every rank builds the solver of the same problem and
parameters, sharded over all N ranks (``mesh_axis`` ``constr``: each cone's
hot operators by constraint; ``row``: each cone's factor rows), and runs
what ``measure`` runs: the ALM phase from the fresh carry (starting factors,
rho0 = 1 / sqrt(n), ``prepare``), warmed up by one JAX dispatch's worth of
outer iterations, then timed from the fresh carry again until a terminal
code or the JAX loop's cap of 8 dispatches.  A dispatch is emulated on the
host: it ends after 25 outer iterations or, at a sub-loop pass, once the
pass would start past the phase's inner-iteration budget (the JAX yield,
which changes no iterate).  With N = 1 asked for, the unsharded solver
runs first, in the calling process (the JAX script's own one-device row, on
the replayed loops on the card); the speedup is read against the sharded
N = 1 row, since sharded solves run the eager loops.

The problem is the JAX script's ``random_maxcut_problem(8192,
avg_degree=16, seed=7)`` with ``SolverParams(dtype="float64",
disable_oracle=True, fixed_rank=16)``, or with ``--delaunay K`` the
Delaunay MaxCut of 2^K seeded points (seed K; K = 20 is ``chip_smoke.py``'s
``[dn20]`` instance) under the same parameters.  Each row keeps the JAX
keys (``devices``, ``inner_iters``, ``seconds``,
``alm_inner_iters_per_sec``, ``speedup_vs_1dev``) and adds the mode, each
rank's peak device memory, the collectives a rank issued in the timed run
and their bytes, and the mean time of one collective of the run's mean
payload (CUDA events over 50 all-reduces after the run).  The file adds the
card's name and power limit (``nvidia-smi``) and the peer-access matrix of
the host's cards.  Ranks run on the card unless ``--device cpu`` (gloo); an
NCCL world larger than the card count is refused, never stacked on one card
or moved to gloo.  With no row measured the script writes nothing and
returns 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import SolverParams
from ..io.maxcut import maxcut_problem_from_adjacency
from ..ops import kernels as K
from ..parallel.launch import check_nccl_world, spawn
from ..parallel.mesh import collective_ms, make_mesh
from ..problem import SDPProblem
from ..solver.alm import CODE_CONTINUE, make_alm_carry, make_outer_ctrl
from ..solver.common import HostSync
from ..solver.common import init_factors as draw_init_factors
from ..solver.driver import Solver
from ..solver.rank import make_rank_state
from ..testing import delaunay_maxcut_adjacency, random_maxcut_problem

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_N, JAX_DEGREE, JAX_SEED, JAX_RANK = 8192, 16, 7, 16
MAX_DISPATCHES = 8      # measure's loop (scripts/scaling_report.py:70)
MAX_OUTER = 25          # outer iterations a JAX dispatch runs at most


def jax_params() -> SolverParams:
    return SolverParams(dtype="float64", disable_oracle=True,
                        fixed_rank=JAX_RANK)


def jax_problem(n: int = JAX_N) -> SDPProblem:
    return random_maxcut_problem(n, avg_degree=JAX_DEGREE, seed=JAX_SEED)


def delaunay_problem(k: int) -> SDPProblem:
    return maxcut_problem_from_adjacency(
        delaunay_maxcut_adjacency(2 ** k, seed=k), name=f"delaunay_n{k}")


class _DispatchCap(Exception):
    """The JAX loop's last dispatch yielded: the measurement ends."""


def fresh_carry(solver: Solver, R0):
    """The ALM phase of ``solver`` and its fresh carry and control built on
    the whole starting factors ``R0`` (this rank keeps its rows), prepared:
    ``measure``'s state before its timed loop."""
    p = solver.params
    alm, _ = solver._phases([int(r.shape[1]) for r in R0], HostSync())
    R = tuple(solver._own_rows(i, torch.tensor(
        r, dtype=solver.dtype, device=solver.device))
        for i, r in enumerate(R0))
    rho0 = 1.0 / np.sqrt(sum(solver.prob.block_dims))
    carry = alm.prepare(make_alm_carry(R, solver.m_local, alm.n_elems, rho0,
                                       p))
    return alm, carry, make_outer_ctrl(p, 1, 1, p.alm_rho_factor)


def run_dispatches(alm, carry, ctrl, max_dispatches: int = MAX_DISPATCHES):
    """Outer iterations of the main ALM phase as the JAX ``measure``
    dispatches them, until a terminal code or the end of dispatch
    ``max_dispatches``; returns (inner iterations, dispatches)."""
    p = alm.params
    st = {"n": 1, "start": 0, "j": 0}

    def next_dispatch():
        if st["n"] == max_dispatches:
            raise _DispatchCap
        st.update(n=st["n"] + 1, start=ctrl.inner_total, j=0)

    sub_pass = alm._sub_normal

    def budgeted_pass(carry, ctrl, **kw):
        # the JAX sub-loop yields before a pass that would start past the
        # dispatch's budget; the next dispatch resumes it
        if ctrl.inner_total - st["start"] >= alm.inner_budget:
            next_dispatch()
        return sub_pass(carry, ctrl, **kw)

    alm._sub_normal = budgeted_pass
    try:
        while True:
            carry = alm.outer_step(
                carry, ctrl, mode="main", early_stop=False, is_rank_max=True,
                rank_thresh=1e9, max_alm_iter=int(p.max_alm_iter))
            if ctrl.code != CODE_CONTINUE:
                break
            st["j"] += 1
            if st["j"] == MAX_OUTER:
                next_dispatch()
    except _DispatchCap:
        pass
    finally:
        del alm._sub_normal
    return ctrl.inner_total, st["n"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _collectives(solver: Solver, mesh, reset: bool = False):
    """(calls, bytes) of the collectives ``solver``'s operators issued."""
    if mesh is None:
        return 0, 0
    if solver.red is not None:
        if reset:
            solver.red.calls = solver.red.bytes = 0
        return solver.red.calls, solver.red.bytes
    if reset:
        for c in solver.cones:
            c.allreduce_calls = c.allreduce_bytes = 0
    return (sum(c.allreduce_calls for c in solver.cones),
            sum(c.allreduce_bytes for c in solver.cones))


def measure(build: Callable[[], Solver], R0, device: torch.device,
            mesh=None, axis: str = "constr") -> dict:
    """One rank's row: the solver from ``build`` (on axis ``axis`` of
    ``mesh``, or alone on ``device``) warmed up by one dispatch, then timed
    over the measured phase; its peak device memory above what was
    allocated before it was built."""
    group = None if mesh is None else mesh.group(axis)
    if device.type == "cuda":
        torch.cuda.init()       # the memory statistics need the allocator
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    solver = build()
    run_dispatches(*fresh_carry(solver, R0), max_dispatches=1)
    state = fresh_carry(solver, R0)
    _collectives(solver, mesh, reset=True)
    _sync(device)
    if mesh is not None:
        dist.barrier(group=group)
    t = time.perf_counter()
    inner, dispatches = run_dispatches(*state)
    _sync(device)
    dt = max(time.perf_counter() - t, 1e-9)
    calls, nbytes = _collectives(solver, mesh)
    row = {"mode": "unsharded" if mesh is None else "sharded",
           "inner_iters": int(inner), "dispatches": dispatches,
           "seconds": dt, "collectives": calls, "collective_bytes": nbytes,
           "ms_per_collective": None, "peak_bytes": None}
    if device.type == "cuda":
        row["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    if calls:
        row["ms_per_collective"] = collective_ms(group, nbytes // calls,
                                                 device)
    return row


def _rank(prob: SDPProblem, params: SolverParams, axis: str,
          device: Optional[str], R0) -> dict:
    """One rank of a world: its row of the sharded solver."""
    mesh = make_mesh(axis_names=("batch", axis), device=device)
    return measure(lambda: Solver(prob, params, mesh=mesh, mesh_axis=axis),
                   R0, mesh.device, mesh, axis)


def unsharded(prob: SDPProblem, params: SolverParams,
              device: Optional[str], R0) -> dict:
    """The unsharded solver's row, measured in this process (no process
    group; on the CPU on one torch thread, as every rank runs)."""
    dev = resolve_device(device)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)
    try:
        return measure(lambda: Solver(prob, params, device=dev), R0, dev)
    finally:
        torch.set_num_threads(threads)


def card_lines() -> Optional[List[str]]:
    """``nvidia-smi``'s name and power limit of every card, or None where
    there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()


def peer_access() -> List[List[bool]]:
    """``can_device_access_peer`` between every two of the host's cards
    (True on the diagonal)."""
    n = torch.cuda.device_count()
    return [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]


def starting_factors(prob: SDPProblem, params: SolverParams):
    """The solve's own starting factors (``Solver.solve``'s draw), whole,
    as numpy."""
    ranks = make_rank_state(prob, params).ranks
    R, _ = draw_init_factors(
        ranks, prob.block_dims, prob.n_lp_cols,
        torch.Generator().manual_seed(int(params.seed)), "cpu")
    return [r.numpy() for r in R]


def report(devices: Sequence[int], prob: SDPProblem, params: SolverParams,
           axis: str = "constr", device: Optional[str] = None
           ) -> Optional[dict]:
    """The scaling rows of ``prob`` at each world size of ``devices`` (the
    artifact's payload), each from :func:`starting_factors`, or None when
    no row was measured."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = "gloo" if on_cpu else "nccl"
    if not on_cpu:
        check_nccl_world(max(devices))
        K.build_kernels()       # once, before the ranks use them
    R0 = starting_factors(prob, params)
    rows = []

    def add(ws, every, wall):
        row = every[0]
        if any(r["inner_iters"] != row["inner_iters"] for r in every):
            raise RuntimeError(f"devices={ws}: the ranks' inner iterations "
                               f"differ: {[r['inner_iters'] for r in every]}")
        rows.append({
            "devices": ws, **{f: row[f] for f in (
                "mode", "inner_iters", "seconds", "dispatches", "collectives",
                "collective_bytes", "ms_per_collective")},
            "alm_inner_iters_per_sec": row["inner_iters"] / row["seconds"],
            "seconds_by_rank": [r["seconds"] for r in every],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in every],
            "backend": None if row["mode"] == "unsharded" else backend,
            "start_to_join_s": wall})
        print(json.dumps(rows[-1]), flush=True)

    if 1 in devices:
        add(1, [unsharded(prob, params, device, R0)], None)
    for ws in devices:
        t = time.perf_counter()
        try:
            ranks = spawn(_rank, ws, (prob, params, axis, device, R0),
                          backend=backend)
        except Exception:       # the next world size may still run
            print(f"devices={ws}: no row\n{traceback.format_exc()[-2000:]}",
                  flush=True)
            continue
        add(ws, ranks, time.perf_counter() - t)
    if not rows:
        return None
    base = next((r for r in rows if r["devices"] == 1
                 and r["mode"] == "sharded"), None)
    for r in rows:
        if base is not None:
            r["speedup_vs_1dev"] = (r["alm_inner_iters_per_sec"]
                                    / base["alm_inner_iters_per_sec"])
    cuda = not on_cpu
    return {
        "what": f"ALM inner iterations/second of the port's {axis}-sharded "
                f"solver on N ranks ({backend}, "
                f"{'one card a rank' if cuda else 'CPU'}): {prob.name}, n="
                f"{prob.block_dims[0]}, rank {R0[0].shape[1]}, "
                f"{params.dtype}",
        "note": "Each world size is a fresh torch.distributed world (one "
                "rank a card over NCCL, gloo on the CPU); every rank runs "
                "the measured ALM phase of the JAX script's measure from "
                "the fresh carry (dispatches emulated on the host: 25 outer "
                "iterations, the inner-iteration budget, at most 8). "
                "devices=1 has two rows: the unsharded solver (the JAX "
                "script's one-device row; on the card it replays CUDA "
                "graphs) and the sharded solver on one rank (the eager "
                "loops, as every sharded solve); speedup_vs_1dev is read "
                "against the sharded row. inner_iters must be identical "
                "across rows on the constraint axis (exact sums by "
                "ownership); on the row axis the rank-order sums of each "
                "world size may round apart. collectives / "
                "collective_bytes: one rank's, in the timed run; "
                "ms_per_collective: CUDA events (host clock on the CPU) "
                "over 50 all-reduces of the run's mean payload after it.",
        "axis": axis, "backend": backend,
        "problem": {"name": prob.name, "n": prob.block_dims[0], "m": prob.m,
                    "rank": int(R0[0].shape[1])},
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "cards": card_lines() if cuda else None,
        "peer_access": peer_access() if cuda else None,
        "rows": rows,
        "host_cpus": os.cpu_count(),
    }


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="1,2,4",
                    help="world sizes, comma-separated")
    ap.add_argument("--axis", default="constr", choices=["constr", "row"])
    ap.add_argument("--delaunay", type=int, default=None, metavar="K",
                    help="the Delaunay MaxCut of 2^K points (seed K) in "
                         "place of the JAX script's random MaxCut")
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU (default: one card "
                         "a rank)")
    ap.add_argument("--out", default=None,
                    help="the artifact (default: scaling_<axis>.json beside "
                         "this script)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    devices = [int(x) for x in args.devices.split(",")]
    out = args.out or os.path.join(HERE, f"scaling_{args.axis}.json")
    on_cpu = args.device is not None and torch.device(args.device).type \
        == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            print("scaling_report: no CUDA device is available; pass "
                  "--device cpu for gloo ranks on the CPU", file=sys.stderr)
            return 2
        try:
            check_nccl_world(max(devices))
        except ValueError as e:
            print(f"scaling_report: {e}", file=sys.stderr)
            return 2
    prob = (jax_problem() if args.delaunay is None
            else delaunay_problem(args.delaunay))
    payload = report(devices, prob, jax_params(), args.axis, args.device)
    if payload is None:
        print("ERROR: no scaling rows measured — refusing to write an "
              "empty artifact", file=sys.stderr)
        return 1
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
