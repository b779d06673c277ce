"""Multi-objective rank-schedule loss (PyTorch).

The counterpart of ``ltr_lowrank_sdp_tpu/models/loss.py`` (reference
``train.py:34-184``), term for term:

1. masked log-space MSE on rank values with under-prediction up-weighting,
2. cross-entropy with label smoothing on the schedule length class,
3. monotonicity penalty ReLU(-(r_{t+1} - r_t)) over valid adjacent pairs,
4. auxiliary initial-rank log-L1,
5. auxiliary final-rank log-L1 with under-prediction up-weighting.

Terms 2 and 5 are means over every row of the batch, the rows that pad the
graph axis included (target length 0, target 0), as in the JAX package: such
a row adds |log p - log 1e-6| to term 5.  The port keeps that.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossWeights:
    schedule_weight: float = 1.0
    length_weight: float = 0.5
    mono_weight: float = 0.1
    initial_weight: float = 0.25
    final_weight: float = 0.25
    under_weight: float = 2.5
    label_smoothing: float = 0.1
    eps: float = 1e-6


def rank_schedule_loss(
    pred_schedule: torch.Tensor, target_schedule: torch.Tensor,
    pred_length_logits: torch.Tensor, target_length: torch.Tensor,
    mask: torch.Tensor, pred_initial: Optional[torch.Tensor] = None,
    w: LossWeights = LossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, dict of components)."""
    eps = w.eps
    pred_log = torch.log(torch.clamp(pred_schedule, min=eps))
    target_log = torch.log(torch.clamp(target_schedule, min=eps))
    sq = (pred_log - target_log) ** 2
    weights = torch.where(pred_schedule < target_schedule, w.under_weight,
                          1.0).to(pred_schedule.dtype)
    num_valid = torch.sum(mask * weights) + eps
    schedule_loss = torch.sum(sq * mask * weights) / num_valid

    T = pred_length_logits.shape[-1]
    tl = torch.clamp(target_length.reshape(-1) - 1, 0, T - 1).long()
    onehot = F.one_hot(tl, T).to(pred_length_logits.dtype)
    smooth = onehot * (1 - w.label_smoothing) + w.label_smoothing / T
    logp = F.log_softmax(pred_length_logits, dim=-1)
    length_loss = -torch.mean(torch.sum(smooth * logp, dim=-1))

    zero = pred_schedule.new_zeros(())
    if w.mono_weight > 0:
        pen = F.relu(-(pred_schedule[:, 1:] - pred_schedule[:, :-1]))
        mm = mask[:, 1:] * mask[:, :-1]
        mono_loss = torch.sum(pen * mm) / (torch.sum(mm) + eps)
    else:
        mono_loss = zero

    if pred_initial is not None:
        init_m = mask[:, :1]
        d = torch.abs(torch.log(torch.clamp(pred_initial, min=eps))
                      - torch.log(torch.clamp(target_schedule[:, :1],
                                              min=eps)))
        init_loss = torch.sum(d * init_m) / (torch.sum(init_m) + eps)
    else:
        init_loss = zero

    final_pos = torch.clamp(target_length.reshape(-1) - 1, 0,
                            pred_schedule.shape[1] - 1).long()
    pf = torch.gather(pred_schedule, 1, final_pos[:, None])[:, 0]
    tf_ = torch.gather(target_schedule, 1, final_pos[:, None])[:, 0]
    f_under = (pf < tf_).to(pf.dtype) * (w.under_weight - 1.0) + 1.0
    f_diff = torch.abs(torch.log(torch.clamp(pf, min=eps))
                       - torch.log(torch.clamp(tf_, min=eps)))
    final_loss = torch.mean(f_diff * f_under)

    total = (w.schedule_weight * schedule_loss
             + w.length_weight * length_loss
             + w.mono_weight * mono_loss
             + w.initial_weight * init_loss
             + w.final_weight * final_loss)
    return total, {
        "schedule_loss": schedule_loss,
        "length_loss": length_loss,
        "mono_loss": mono_loss,
        "init_loss": init_loss,
        "final_loss": final_loss,
        "total_loss": total,
    }
