"""Rank machinery: escalation, caps, and GNN schedule injection.

The reference escalates rank by ``rankUpdateFactor`` when the ALM difficulty
grading accumulates past the dyrankLevel threshold (``AUG_RANK``,
``lorads_solver.c:1154-1254``), padding factors with a 1/sqrt(r)-scaled
identity.  On TPU a rank change is a *shape* change: we pad the factors and
rebuild the compiled phase for the new rank signature (one executable per
rank bucket — this is precisely why externally predicted rank schedules fit
XLA so well).

Rank-schedule injection (the released binary's ``--rankSchedule`` +
``--nearStallFactor``; semantics inferred from ``benchmark.py:240-254`` and
the stall machinery it replaces): the solver starts at schedule[0] and, each
time the stall signal fires (threshold scaled by ``near_stall_factor`` so the
jump happens *near* the stall rather than after it), jumps to the next
schedule entry instead of multiplying by rankUpdateFactor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..config import SolverParams
from .common import pad_rank_columns


@dataclasses.dataclass
class RankState:
    ranks: List[int]
    rank_caps: List[int]
    schedule: Optional[List[int]] = None
    schedule_pos: int = 0
    fixed: bool = False

    @property
    def is_rank_max(self) -> bool:
        if self.fixed:
            return True
        return all(r >= cap for r, cap in zip(self.ranks, self.rank_caps))

    def stall_threshold(self, params: SolverParams) -> float:
        thresh = params.rank_flag_threshold()
        if self.schedule is not None:
            thresh *= params.near_stall_factor
        return thresh

    def next_ranks(self, factor: float) -> List[int]:
        """Target ranks for one escalation step."""
        if self.fixed:
            return list(self.ranks)
        if self.schedule is not None:
            if self.schedule_pos + 1 >= len(self.schedule):
                # schedule exhausted but the solver still stalls: the
                # predicted trajectory was a PREFIX guide (the released
                # binary's behavior past the last entry is unobservable —
                # no source, SURVEY §2.2); resume the default
                # rankUpdateFactor escalation so an under-predicted
                # schedule degrades to the heuristic instead of pinning
                # the solve below the rank it needs
                return [
                    min(int(np.ceil(r * factor)), cap)
                    for r, cap in zip(self.ranks, self.rank_caps)
                ]
            nxt = self.schedule[self.schedule_pos + 1]
            return [
                max(r, min(int(nxt), cap))
                for r, cap in zip(self.ranks, self.rank_caps)
            ]
        return [
            min(int(np.ceil(r * factor)), cap)
            for r, cap in zip(self.ranks, self.rank_caps)
        ]

    def escalate(self, factor: float):
        """Apply one escalation step; returns True if ranks changed."""
        new = self.next_ranks(factor)
        changed = new != self.ranks
        self.ranks = new
        if self.schedule is not None and changed:
            self.schedule_pos += 1
        return changed


def make_rank_state(prob, params: SolverParams) -> RankState:
    from ..problem import initial_ranks

    if params.rank_schedule:
        sched = [max(1, int(r)) for r in params.rank_schedule]
        ranks0, caps = initial_ranks(prob, params.times_log_rank, -1,
                                     init_rank=sched[0])
        return RankState(ranks=ranks0, rank_caps=caps, schedule=sched)
    ranks0, caps = initial_ranks(
        prob, params.times_log_rank, params.fixed_rank, params.init_rank
    )
    return RankState(
        ranks=ranks0, rank_caps=caps, fixed=params.fixed_rank > 0
    )


def pad_factor_tuple(factors, new_ranks):
    return tuple(
        pad_rank_columns(f, r) for f, r in zip(factors, new_ranks)
    )
