"""Model building blocks (PyTorch): MLP encoders, attention pooling, and the
autoregressive LSTM sequence decoder.

The counterparts of ``ltr_lowrank_sdp_tpu/models/layers.py``, whose contract
matches ``model/layers.py`` of the reference:

* ``MLPBlock``: Linear -> LayerNorm (epsilon 1e-6, Flax's) -> ReLU ->
  Dropout -> Linear (``:13-56``);
* Node/Edge/Global encoders project the 16/5/17 raw features (``:59-187``);
* ``AttentionPooling``: tanh-MLP scores (matrix products) and the per-graph
  softmax-weighted sum, which is K10's third part; dropout on the weights is
  K10's keep-scale (``:189-262``);
* ``SequenceDecoder`` (``:265-485``): LSTM whose input at every step is
  [rank-embedding, context]; rank head predicts log-rank clamped to
  [-2, 10] then exponentiated; length head is a max_seq_len-way classifier;
  initial-rank prior head is softplus + min_rank; the teacher-forced decode
  of training with one coin per step shared by the batch, and the
  autoregressive ``generate``.

Dropout is Flax's (keep with probability 1 - p, scale by 1 / (1 - p)) and
acts in training mode only (``module.train()``).  Its masks are drawn from
the ``generator`` the caller passes, never from a hidden global state.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels as K

LAYER_NORM_EPS = 1e-6      # flax.linen.LayerNorm's default


def keep_scale(shape, p: float, generator: Optional[torch.Generator],
               device, dtype=torch.float32) -> Optional[torch.Tensor]:
    """Flax's dropout mask as a scale: ``1 / (1 - p)`` where an element is
    kept (probability 1 - p), 0 where it is dropped; ``None`` when p is 0."""
    if p == 0.0:
        return None
    if p >= 1.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return (u < 1.0 - p).to(dtype) / (1.0 - p)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``flax.linen.Dropout(rate=p)`` with its mask from ``generator``."""
    keep = keep_scale(x.shape, p, generator, x.device, x.dtype)
    return x if keep is None else x * keep


class MLPBlock(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 norm_type: str = "layer", dropout: float = 0.0):
        super().__init__()
        if norm_type != "layer":
            raise NotImplementedError(
                f"norm_type {norm_type!r}: only 'layer' is ported")
        self.p = dropout
        self.dense_0 = nn.Linear(in_dim, hidden_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.dense_1 = nn.Linear(hidden_dim, out_dim)

    def _p(self) -> float:
        return self.p if self.training else 0.0

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(self.norm(self.dense_0(x)))
        return self.dense_1(dropout(h, self._p(), generator))

    def zero_rows_sum(self, k: int,
                      generator: Optional[torch.Generator] = None):
        """The sum of the block's outputs on ``k`` rows of zeros, each with
        its own dropout mask, without the rows: the hidden units of the sum
        keep a Binomial(k, 1 - p) count of the k copies, which is the
        distribution of k independent masks."""
        h = F.relu(self.norm(self.dense_0.bias))
        p = self._p()
        if p >= 1.0:
            h = torch.zeros_like(h)
        elif p > 0.0 and k > 0:
            kept = torch.binomial(torch.full_like(h, float(k)),
                                  torch.full_like(h, 1.0 - p),
                                  generator=generator)
            h = h * kept / (1.0 - p)
        else:
            h = h * float(k)
        return F.linear(h, self.dense_1.weight) + k * self.dense_1.bias


class _Encoder(nn.Module):
    """One MLPBlock from ``in_dim`` to ``out_dim`` features (the Node, Edge
    and Global encoders differ only in name)."""

    def __init__(self, in_dim: int, out_dim: int, norm_type: str = "layer",
                 dropout: float = 0.0):
        super().__init__()
        self.mlp = MLPBlock(in_dim, out_dim, out_dim, norm_type, dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.mlp(x, generator)


class NodeEncoder(_Encoder):
    pass


class EdgeEncoder(_Encoder):
    pass


class GlobalEncoder(_Encoder):
    pass


class AttentionPooling(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.p = dropout
        self.dense_0 = nn.Linear(in_dim, hidden_dim)
        self.dense_1 = nn.Linear(hidden_dim, 1)

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) node embeddings -> (N,) attention scores."""
        return self.dense_1(torch.tanh(self.dense_0(x)))[:, 0]

    def keep(self, n: int, generator: Optional[torch.Generator],
             device) -> Optional[torch.Tensor]:
        """The dropout keep-scale (N,) of the attention weights, or None."""
        return keep_scale((n,), self.p if self.training else 0.0, generator,
                          device)

    def forward(self, x: torch.Tensor, seg: K.GraphSegments,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, D) -> (B, D): the attention part of one K10 launch (the
        encoder takes all three parts of that launch)."""
        d = x.shape[1]
        return K.graph_pool(seg, x, self.score(x),
                            self.keep(x.shape[0], generator, x.device)
                            )[:, 2 * d:]


Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


class LSTMCell(nn.Module):
    """Flax's ``nn.LSTMCell``: four input kernels without bias (``ii, if,
    ig, io``) and four hidden kernels with bias (``hi, hf, hg, ho``), held
    here as one input and one hidden product in the gate order i, f, g, o."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.ih = nn.Linear(in_dim, 4 * hidden_dim, bias=False)
        self.hh = nn.Linear(hidden_dim, 4 * hidden_dim)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        """carry (c, h) -> ((c', h'), h')."""
        c, h = carry
        i, f, g, o = torch.chunk(self.ih(x) + self.hh(h), 4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class _LSTMStack(nn.Module):
    """``num_layers`` LSTM cells; the carry holds (c, h) per layer; dropout
    between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.cells = nn.ModuleList(
            LSTMCell(in_dim if layer == 0 else hidden_dim, hidden_dim)
            for layer in range(num_layers))

    def forward(self, carry: Carry, x: torch.Tensor, p: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Carry, torch.Tensor]:
        new_carry: List[Tuple[torch.Tensor, torch.Tensor]] = []
        inp = x
        for layer, (cell, layer_carry) in enumerate(zip(self.cells, carry)):
            layer_carry, inp = cell(layer_carry, inp)
            new_carry.append(layer_carry)
            if layer + 1 < len(self.cells):
                inp = dropout(inp, p, generator)
        return tuple(new_carry), inp


class SequenceDecoder(nn.Module):
    def __init__(self, context_dim: int, hidden_dim: int = 128,
                 num_layers: int = 2, max_seq_len: int = 16,
                 min_rank: float = 1.0, dropout: float = 0.0):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.num_layers = num_layers
        self.max_seq_len = max_seq_len
        self.min_rank = min_rank
        self.p = dropout
        self.embed_rank = nn.Sequential(nn.Linear(1, h // 2), nn.ReLU(),
                                        nn.Linear(h // 2, h))
        self.lstm = _LSTMStack(h + context_dim, h, num_layers)
        self.context_to_h = nn.Linear(context_dim, h * num_layers)
        self.context_to_c = nn.Linear(context_dim, h * num_layers)
        self.out_dense1 = nn.Linear(h, h // 2)
        self.out_dense2 = nn.Linear(h // 2, 1)
        self.len_dense1 = nn.Linear(context_dim, h)
        self.len_dense2 = nn.Linear(h, max_seq_len)
        self.init_dense1 = nn.Linear(context_dim, h)
        self.init_dense2 = nn.Linear(h, 1)

    def _init_carry(self, context: torch.Tensor) -> Carry:
        B = context.shape[0]
        h = self.context_to_h(context).reshape(B, self.num_layers,
                                               self.hidden_dim)
        c = self.context_to_c(context).reshape(B, self.num_layers,
                                               self.hidden_dim)
        return tuple((c[:, layer, :], h[:, layer, :])
                     for layer in range(self.num_layers))

    def _rank_head(self, out, p, generator) -> torch.Tensor:
        y = dropout(F.relu(self.out_dense1(out)), p, generator)
        log_rank = torch.clamp(self.out_dense2(y), -2.0, 10.0)
        return torch.exp(log_rank)[:, 0]

    def _length_head(self, context, p=0.0, generator=None) -> torch.Tensor:
        y = dropout(F.relu(self.len_dense1(context)), p, generator)
        return self.len_dense2(y)

    def _initial_head(self, context, p=0.0, generator=None) -> torch.Tensor:
        y = dropout(F.relu(self.init_dense1(context)), p, generator)
        return F.softplus(self.init_dense2(y)) + self.min_rank

    def _decode(self, context, cur, target, coins, mode: str, tf_ratio,
                p: float, generator) -> torch.Tensor:
        """The decode steps (``_step`` scanned over T in the JAX package);
        ``mode`` is 'coin' (per-step teacher-forcing coin), 'teacher' or
        'free'.  A prediction fed back is detached, as ``stop_gradient``
        has it.  -> predictions (B, T)."""
        carry = self._init_carry(context)
        preds = []
        for t in range(self.max_seq_len):
            emb = self.embed_rank(cur[:, None])
            carry, out = self.lstm(carry, torch.cat([emb, context], dim=-1),
                                   p, generator)
            pred = self._rank_head(out, p, generator)
            preds.append(pred)
            if mode == "coin":
                cur = torch.where(coins[t] < tf_ratio, target[:, t],
                                  pred.detach())
            elif mode == "teacher":
                cur = target[:, t]
            else:
                cur = pred.detach()
        return torch.stack(preds, dim=1)

    def forward(self, context: torch.Tensor,
                target_schedule: Optional[torch.Tensor] = None,
                target_mask: Optional[torch.Tensor] = None,
                teacher_forcing_ratio=0.5, use_target_init: bool = True, *,
                generator: Optional[torch.Generator] = None,
                coins: Optional[torch.Tensor] = None):
        """Teacher-forced decode -> (predictions (B, T), length_logits
        (B, T), init_rank (B, 1)).  With a target and ``coins`` (T,) or a
        ``generator`` to draw them from, step t feeds back the target where
        ``coins[t] < teacher_forcing_ratio`` and its own prediction
        elsewhere; with a target and neither, always the target; without
        one, always the prediction.  ``target_mask`` is unused, as in the
        JAX package."""
        p = self.p if self.training else 0.0
        length_logits = self._length_head(context, p, generator)
        init_rank = self._initial_head(context, p, generator)
        if use_target_init and target_schedule is not None:
            cur = target_schedule[:, 0]
        else:
            cur = init_rank[:, 0]
        if target_schedule is not None and (coins is not None
                                            or generator is not None):
            mode = "coin"
            if coins is None:
                coins = torch.rand(self.max_seq_len, generator=generator,
                                   device=context.device,
                                   dtype=context.dtype)
        elif target_schedule is not None:
            mode = "teacher"
        else:
            mode = "free"
        predictions = self._decode(context, cur, target_schedule, coins,
                                   mode, teacher_forcing_ratio, p, generator)
        return predictions, length_logits, init_rank

    def generate(self, context: torch.Tensor, min_rank: float = 1.0):
        """Autoregressive ("free") decode without dropout: (schedule (B, T),
        lengths (B,), init (B, 1))."""
        T = self.max_seq_len
        lengths = torch.clamp(
            torch.argmax(self._length_head(context), dim=-1) + 1, 1, T)
        init_rank = self._initial_head(context)
        preds = self._decode(context, init_rank[:, 0], None, None, "free",
                             0.0, 0.0, None)
        schedule = torch.clamp(preds, min=min_rank)
        return schedule, lengths, init_rank
