"""Solver CLI of the PyTorch port: the flags of ``ltr_lowrank_sdp_tpu/cli.py``
plus ``--device``.

Usage:
    python -m ltr_lowrank_sdp_torch.cli problem.dat-s [--flags ...]
    python -m ltr_lowrank_sdp_torch.cli graph.mat --device cpu

The solve runs on ``cuda:0`` unless ``--device cpu`` is given; without a
GPU and without ``--device cpu`` it stops with an error.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import resolve_device
from .config import OracleRankMethod, SolverParams


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ltr-lowrank-sdp-torch",
        description="Low-rank SDP solver (LoRADS-capability) on PyTorch/CUDA",
    )
    ap.add_argument("fname", help="SDPA sparse (.dat-s) or MaxCut .mat file")
    ap.add_argument("--logfile", default=None)
    ap.add_argument("--jsonfile", default=None)
    ap.add_argument("--initRho", type=float, default=0.0)
    ap.add_argument("--rhoMax", type=float, default=5000.0)
    ap.add_argument("--rhoCellingALM", type=float, default=1e8)
    ap.add_argument("--rhoCellingADMM", type=float, default=5000.0 * 200)
    ap.add_argument("--maxALMIter", type=int, default=200)
    ap.add_argument("--maxADMMIter", type=int, default=10000)
    ap.add_argument("--timesLogRank", type=float, default=2.0)
    ap.add_argument("--fixedRank", type=int, default=-1)
    ap.add_argument("--initRank", type=int, default=-1)
    ap.add_argument("--rhoFreq", type=int, default=5)
    ap.add_argument("--rhoFactor", type=float, default=1.2)
    ap.add_argument("--ALMRhoFactor", type=float, default=2.0)
    ap.add_argument("--rankUpdateFactor", type=float, default=1.5)
    ap.add_argument("--phase1Tol", type=float, default=1e-3)
    ap.add_argument("--phase2Tol", type=float, default=1e-5)
    ap.add_argument("--timeSecLimit", type=float, default=3600.0)
    ap.add_argument("--heuristicFactor", type=float, default=1.0)
    ap.add_argument("--lbfgsListLength", type=int, default=2)
    ap.add_argument("--endTauTol", type=float, default=1e-16)
    ap.add_argument("--endALMSubTol", type=float, default=1e-10)
    ap.add_argument("--l2Rescaling", type=int, default=0)
    ap.add_argument("--reoptLevel", type=int, default=2)
    ap.add_argument("--dyrankLevel", type=int, default=2)
    ap.add_argument("--highAccMode", type=int, default=0)
    ap.add_argument("--oracleRankNaive", action="store_true")
    # released-binary extensions
    ap.add_argument("--rankSchedule", default=None,
                    help="JSON file with {'rank_schedule': [...], "
                         "'schedule_length': N} or a comma-separated list")
    ap.add_argument("--nearStallFactor", type=float, default=0.7)
    ap.add_argument("--disableOracle", action="store_true")
    ap.add_argument("--dtype", default="auto",
                    choices=["auto", "float32", "float64"],
                    help="auto = float64 on every device; float32 is not "
                         "ported yet")
    ap.add_argument("--seed", type=int, default=925)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the solve runs (default: the first GPU)")
    return ap


def params_from_args(args) -> SolverParams:
    schedule = None
    if args.rankSchedule:
        if args.rankSchedule.endswith(".json"):
            with open(args.rankSchedule) as f:
                payload = json.load(f)
            sched = payload["rank_schedule"]
            length = payload.get("schedule_length", len(sched))
            schedule = [int(r) for r in sched[: int(length)]]
        else:
            schedule = [int(x) for x in args.rankSchedule.split(",")]
    return SolverParams(
        init_rho=args.initRho,
        rho_max=args.rhoMax,
        rho_ceiling_alm=args.rhoCellingALM,
        rho_ceiling_admm=args.rhoCellingADMM,
        max_alm_iter=args.maxALMIter,
        max_admm_iter=args.maxADMMIter,
        times_log_rank=args.timesLogRank,
        fixed_rank=args.fixedRank,
        init_rank=args.initRank,
        rho_freq=args.rhoFreq,
        rho_factor=args.rhoFactor,
        alm_rho_factor=args.ALMRhoFactor,
        rank_update_factor=args.rankUpdateFactor,
        phase1_tol=args.phase1Tol,
        phase2_tol=args.phase2Tol,
        time_sec_limit=args.timeSecLimit,
        heuristic_factor=args.heuristicFactor,
        lbfgs_list_length=args.lbfgsListLength,
        end_tau_tol=args.endTauTol,
        end_alm_sub_tol=args.endALMSubTol,
        l2_rescaling=bool(args.l2Rescaling),
        reopt_level=args.reoptLevel,
        dyrank_level=args.dyrankLevel,
        high_acc_mode=bool(args.highAccMode),
        oracle_rank_method=(
            OracleRankMethod.NAIVE if args.oracleRankNaive
            else OracleRankMethod.GRAM
        ),
        rank_schedule=schedule,
        near_stall_factor=args.nearStallFactor,
        disable_oracle=args.disableOracle,
        dtype=args.dtype,
        seed=args.seed,
    )


def main(argv=None):
    """Parse ``argv``, solve, print the DIMACS summary.  Returns the
    :class:`~.solver.driver.SolveResult` (``python -m`` exits 0 on it)."""
    args = build_arg_parser().parse_args(argv)
    params = params_from_args(args)

    from .problem import load_problem
    from .solver.driver import Solver
    from .solver.interrupt import install_sigint_handler
    from .solver.logging import TrajectoryLogger

    # graceful Ctrl-C: stop after the current iteration and report the best
    # iterate (reference SIGINT handling, lorads_utils.c:488-505)
    install_sigint_handler()
    # a missing GPU is reported before the file is read
    device = resolve_device(None if args.device == "cuda" else "cpu")
    prob = load_problem(args.fname)
    print(f"nConstrs = {prob.m}, sdp nBlks = {prob.n_cones}, "
          f"lp Cols = {prob.n_lp_cols}")
    logger = TrajectoryLogger(
        params, problem_name=prob.name, file_path=args.fname,
        log_file=args.logfile, verbose=True,
    )
    res = Solver(prob, params, device=device).solve(
        logger=logger, json_path=args.jsonfile)

    print("-" * 71)
    print("Objective function Value are:")
    print(f"\t 1.Primal Objective:            : {res.pobj:10.6e}")
    print(f"\t 2.Dual Objective:              : {res.dobj:10.6e}")
    print("Dimacs Error are:")
    print(f"\t 1.Constraint Violation(1)      : {res.pinf_l1:10.6e}")
    print(f"\t 2.Dual Infeasibility(1)        : {res.dinf_l1:10.6e}")
    print(f"\t 3.Primal Dual Gap              : {res.gap:10.6e}")
    print(f"\t 4.Primal Variable Semidefinite : {0.0:10.6e}")
    print(f"\t 5.Constraint Violation(Inf)    : {res.pinf_inf:10.6e}")
    print(f"\t 6.Dual Infeasibility(Inf)      : {res.dinf_inf:10.6e}")
    print("-" * 71)
    print(f"status: {res.status.value}  solve_time: {res.solve_time:.3f}s  "
          f"final ranks: {res.final_ranks}  host syncs: {res.host_syncs}")
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
