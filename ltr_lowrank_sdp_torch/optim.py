"""The training optimizer, as the root ``train.py`` builds it with optax.

``optax.chain(clip_by_global_norm(clip), adamw(schedule, weight_decay))``,
wrapped in ``optax.MultiSteps(k)`` for ``--grad-accum k > 1``, with optax's
semantics where they differ from ``torch.optim``'s defaults:

* ``warmup_cosine_decay_schedule(0, lr, W, D, lr * 1e-2)`` is a function of
  the update count, starting at 0: the first update has learning rate 0;
* ``clip_by_global_norm`` leaves the gradients alone below the norm and
  scales them by ``max / norm`` above it, with no ``+1e-6``;
* ``adamw`` decays every parameter (biases and LayerNorm scales too) by
  ``lr * weight_decay``, which is what ``torch.optim.AdamW`` computes per
  step, with the same betas (0.9, 0.999) and eps (1e-8);
* ``MultiSteps`` averages k mini-batch gradients (a running mean) and updates
  on every k-th, so the schedule advances once per k mini-batches; the
  average carries over from one epoch to the next.

A parameter without a gradient gets a zero one, as a leaf of JAX's
gradient tree always has one.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Union

import torch


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps`` (none when it is
    0), then a cosine decay to ``end_value`` at ``decay_steps``."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("the cosine decay needs decay_steps > warmup_steps")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t
                                       / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class TrainOptimizer:
    """Clip, AdamW, the schedule and the gradient averaging of the root
    ``train.py``'s optax chain.  Call :meth:`step` after each mini-batch's
    ``backward()``; it updates the parameters on every ``grad_accum``-th
    call and returns whether it did."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Callable[[int], float]],
                 weight_decay: float, clip_norm: float, grad_accum: int = 1):
        self.params: List[torch.nn.Parameter] = list(params)
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.clip_norm = clip_norm
        self.k = grad_accum
        self.mini_step = 0
        self.count = 0            # updates made (optax's schedule count)
        self.acc: Optional[List[torch.Tensor]] = None
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)

    def _grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    def clip_(self, grads: List[torch.Tensor]) -> None:
        """optax.clip_by_global_norm, in place and without a host read."""
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))

    @torch.no_grad()
    def step(self) -> bool:
        grads = self._grads()
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                self.zero_grad()
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        self.clip_(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        self.zero_grad()
        return True

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
