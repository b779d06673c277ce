"""Solver configuration.

A copy of ``ltr_lowrank_sdp_tpu/config.py`` (the port imports nothing from
the JAX package).  It mirrors the full CLI parameter surface of the LoRADS
solver (``lorads/src/src_semi/main.c:56-154``, ``initCommandLineArgs``) plus
the rank-schedule flags of the released binary (``--rankSchedule``,
``--nearStallFactor``, ``--disableOracle``).

The one semantic difference: ``dtype="auto"`` resolves to float64 on every
device, because the H100 has native FP64 (the JAX package picks float32 on a
TPU only because the TPU emulates float64).  The JAX package's float32-only
knobs (``host_f64_verify``, ``f64_polish``) and its multi-block Jacobi sweep
(``admm_jacobi``) have no effect on this port's single-cone float64 path and
are left out until the slices that need them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


class OracleRankMethod(enum.Enum):
    """How oracle (numerical) rank is computed for trajectory logging.

    GRAM eigendecomposes the r x r Gram matrix of the factor; NAIVE
    eigendecomposes the full n x n matrix X (falling back to GRAM for
    n > 2000, mirroring ``lorads_logging.c:406-451``).
    """

    GRAM = "gram"
    NAIVE = "naive"


class SolverStatus(enum.Enum):
    """Terminal status classification (reference ``main.c:592-602``)."""

    UNKNOWN = "unknown"
    PRIMAL_DUAL_OPTIMAL = "primal_dual_optimal"
    PRIMAL_OPTIMAL = "primal_optimal"
    MAXITER = "maxiter"
    TIME_LIMIT = "time_limit"
    NUMERICAL_ERROR = "numerical_error"


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """All knobs of the two-phase (ALM -> ADMM) low-rank SDP solver.

    Defaults match the reference solver's ``initCommandLineArgs``
    (``main.c:56-86``).
    """

    # --- penalty parameter (rho) laws ---
    init_rho: float = 0.0            # 0 -> rho0 = 1/sqrt(sum block dims)
    rho_max: float = 5000.0
    rho_ceiling_alm: float = 1e8
    rho_ceiling_admm: float = 5000.0 * 200
    rho_freq: int = 5                # ADMM: bump rho every rho_freq iters
    rho_factor: float = 1.2          # ADMM rho growth factor
    alm_rho_factor: float = 2.0      # ALM rho growth factor

    # --- iteration limits ---
    max_alm_iter: int = 200
    max_admm_iter: int = 10000

    # --- rank machinery ---
    times_log_rank: float = 2.0      # initial rank ~ ceil(times_log_rank*log n)
    fixed_rank: int = -1             # >0: freeze rank at this value
    init_rank: int = -1              # >0: start here but stay dynamic
    rank_update_factor: float = 1.5  # rank escalation multiplier
    dyrank_level: int = 2            # 0..3 -> rank_flag threshold inf/150/15/5
    rank_schedule: Optional[Sequence[int]] = None  # GNN-predicted trajectory
    near_stall_factor: float = 0.7   # advance schedule when stall signal >= f

    # --- tolerances ---
    phase1_tol: float = 1e-3
    phase2_tol: float = 1e-5
    end_tau_tol: float = 1e-16
    end_alm_sub_tol: float = 1e-10

    # --- misc control ---
    time_sec_limit: float = 3600.0
    heuristic_factor: float = 1.0    # rho_admm = rho_alm * heuristic_factor
    lbfgs_list_length: int = 2
    l2_rescaling: bool = False
    reopt_level: int = 2
    high_acc_mode: bool = False

    # --- oracle rank / trajectory logging ---
    oracle_rank_method: OracleRankMethod = OracleRankMethod.GRAM
    disable_oracle: bool = False     # skip per-iteration oracle-rank eigh
    oracle_eps: float = 1e-6         # eigenvalue cutoff eps*lambda_max

    # --- knobs of the JAX package (no reference equivalent) ---
    dtype: str = "auto"              # compute dtype; "auto" and "float64"
                                     # mean float64 on every device, float32
                                     # is a later slice of the port
    return_factors: bool = True      # include U/V/dual in SolveResult (a
                                     # device->host transfer of the full
                                     # factors; benchmarks that only need
                                     # metrics turn this off)
    cg_restart_freq: int = 20
    cg_max_iter: int = 800
    constr_refresh_every: int = 25   # recompute A(RR^T) fresh every k inner its
    seed: int = 925                  # factor init seed (reference uses srand(925))

    def rank_flag_threshold(self) -> float:
        """Rank-escalation trigger threshold by dynamic-rank level.

        Reference: ``lorads_alm.c:1252-1260``.
        """
        return {0: 1e8, 1: 150.0, 2: 15.0, 3: 5.0}[self.dyrank_level]

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)
