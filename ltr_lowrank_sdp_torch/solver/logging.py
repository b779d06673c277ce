"""Trajectory recording, oracle rank, and schema-compatible JSON output.

The port of ``ltr_lowrank_sdp_tpu/solver/logging.py``; the JSON schema is
unchanged because it is the training-label interface of the dataset loader:
``{"problem_id", "file_path", "metrics": {oracle_rank, primal_obj, ...},
"trajectory": {"phase_1": {"curr_rank", "oracle_rank"}, "phase_2": {...}}}``
(reference ``lorads_write_json_output``, ``lorads_logging.c:618-712``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np

from ..config import OracleRankMethod, SolverParams
from ..ops.lanczos import oracle_rank_gram, oracle_rank_naive


@dataclasses.dataclass
class TrajectoryLogger:
    params: SolverParams
    problem_name: str = ""
    file_path: str = ""
    log_file: Optional[str] = None
    verbose: bool = True
    phase1_curr: List[int] = dataclasses.field(default_factory=list)
    phase1_oracle: List[int] = dataclasses.field(default_factory=list)
    phase2_curr: List[int] = dataclasses.field(default_factory=list)
    phase2_oracle: List[int] = dataclasses.field(default_factory=list)
    solve_start: float = 0.0
    _fh: Optional[object] = None

    def open(self):
        self.solve_start = time.time()
        if self.log_file:
            self._fh = open(self.log_file, "a")
        return self

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def log(self, msg: str):
        if self.verbose:
            sys.stdout.write(msg)
        if self._fh:
            self._fh.write(msg)
            self._fh.flush()

    # ------------------------------------------------------------------ #

    def oracle_from_grams(self, grams) -> int:
        """Total oracle rank from per-cone r x r Gram matrices (host numpy):
        #eigenvalues > eps * lambda_max."""
        if self.params.disable_oracle:
            return 0
        eps = self.params.oracle_eps
        total = 0
        for g in grams:
            evals = np.linalg.eigvalsh(np.asarray(g, np.float64))
            lam = evals[-1]
            if lam > 0:
                total += int(np.sum(evals > eps * lam))
        return total

    def oracle_rank(self, factors, phase: int, avg_with=None) -> int:
        """Total oracle rank across cones (phase 1: R; phase 2: (U+V)/2)."""
        if self.params.disable_oracle:
            return 0
        eps = self.params.oracle_eps
        total = 0
        for i, f in enumerate(factors):
            g = f if avg_with is None else 0.5 * (f + avg_with[i])
            if self.params.oracle_rank_method == OracleRankMethod.NAIVE:
                total += int(oracle_rank_naive(g, eps))
            else:
                total += int(oracle_rank_gram(g, eps))
        return total

    def record_alm_row(self, stat_row, outer_iter, inner_iter, grams,
                       curr_rank, phase_time):
        """One ALM outer iteration.  stat_row layout: [code k inner rank_flag
        pobj dobj pinf_l1 pinf_inf gap rho]."""
        oracle = self.oracle_from_grams(grams)
        self.phase1_curr.append(curr_rank)
        self.phase1_oracle.append(oracle)
        self.log(
            "ALM OuterIter:%d InnerIter:%d pObj:%5.5e dObj:%5.5e "
            "pInfea(1):%5.5e pInfea(Inf):%5.5e pdGap:%5.5e rho:%3.2f "
            "CurrRank:%d OracleRank:%d Time:%3.2f\n"
            % (
                outer_iter, inner_iter, stat_row[4], stat_row[5],
                stat_row[6], stat_row[7], stat_row[8], stat_row[9],
                curr_rank, oracle, phase_time,
            )
        )

    def record_admm_row(self, stat_row, grams, it, curr_rank, nblk,
                        phase_time):
        """One ADMM iteration.  stat_row = [pobj dobj pinf_l1 pinf_inf gap
        rho cg_iters]."""
        oracle = self.oracle_from_grams(grams)
        self.phase2_curr.append(curr_rank)
        self.phase2_oracle.append(oracle)
        self.log(
            "ADMM Iter:%d pObj:%5.5e dObj:%5.5e pInfea(1):%5.5e "
            "pInfea(Inf):%5.5e pdGap:%5.5e rho:%3.2f cgIter:%d CurrRank:%d "
            "OracleRank:%d Time:%3.2f\n"
            % (
                it, stat_row[0], stat_row[1], stat_row[2], stat_row[3],
                stat_row[4], stat_row[5], int(stat_row[6]) // max(1, nblk),
                curr_rank, oracle, phase_time,
            )
        )

    # ------------------------------------------------------------------ #

    def write_json(self, path, final_oracle_rank, pobj, dobj, pinf_l1,
                   pinf_inf, gap, solve_time, rho_max, heuristic_factor):
        payload = {
            "problem_id": self.problem_name,
            "file_path": self.file_path,
            "metrics": {
                "oracle_rank": int(final_oracle_rank),
                "primal_obj": float(pobj),
                "dual_obj": float(dobj),
                "constr_violation_l1": float(pinf_l1),
                "constr_violation_inf": float(pinf_inf),
                "primal_dual_gap": float(gap),
                "solve_time_sec": float(solve_time),
                "rho_max": float(rho_max),
                "heuristic_factor": float(heuristic_factor),
            },
            "trajectory": {
                "phase_1": {
                    "curr_rank": self.phase1_curr,
                    "oracle_rank": self.phase1_oracle,
                },
                "phase_2": {
                    "curr_rank": self.phase2_curr,
                    "oracle_rank": self.phase2_oracle,
                },
            },
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        self.log(f"JSON output written to: {path}\n")
