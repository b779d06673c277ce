"""Model building blocks (PyTorch): MLP encoders, attention pooling, and the
autoregressive LSTM sequence decoder, for inference.

The counterparts of ``ltr_lowrank_sdp_tpu/models/layers.py``, whose contract
matches ``model/layers.py`` of the reference:

* ``MLPBlock``: Linear -> LayerNorm (epsilon 1e-6, Flax's) -> ReLU ->
  Linear (``:13-56``);
* Node/Edge/Global encoders project the 16/5/17 raw features (``:59-187``);
* ``AttentionPooling``: tanh-MLP scores (matrix products) and the per-graph
  softmax-weighted sum, which is K10's third part (``:189-262``);
* ``SequenceDecoder`` (``:265-485``): LSTM whose input at every step is
  [rank-embedding, context]; rank head predicts log-rank clamped to
  [-2, 10] then exponentiated; length head is a max_seq_len-way classifier;
  initial-rank prior head is softplus + min_rank; autoregressive
  ``generate``.  The teacher-forced decode of training comes with the
  training slice.

Dropout is the identity at inference and is left out.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels as K

LAYER_NORM_EPS = 1e-6      # flax.linen.LayerNorm's default


class MLPBlock(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 norm_type: str = "layer"):
        super().__init__()
        if norm_type != "layer":
            raise NotImplementedError(
                f"norm_type {norm_type!r}: only 'layer' is ported")
        self.dense_0 = nn.Linear(in_dim, hidden_dim)
        self.norm = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        self.dense_1 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_1(F.relu(self.norm(self.dense_0(x))))


class _Encoder(nn.Module):
    """One MLPBlock from ``in_dim`` to ``out_dim`` features (the Node, Edge
    and Global encoders differ only in name)."""

    def __init__(self, in_dim: int, out_dim: int, norm_type: str = "layer"):
        super().__init__()
        self.mlp = MLPBlock(in_dim, out_dim, out_dim, norm_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class NodeEncoder(_Encoder):
    pass


class EdgeEncoder(_Encoder):
    pass


class GlobalEncoder(_Encoder):
    pass


class AttentionPooling(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.dense_0 = nn.Linear(in_dim, hidden_dim)
        self.dense_1 = nn.Linear(hidden_dim, 1)

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) node embeddings -> (N,) attention scores."""
        return self.dense_1(torch.tanh(self.dense_0(x)))[:, 0]

    def forward(self, x: torch.Tensor,
                seg: K.GraphSegments) -> torch.Tensor:
        """(N, D) -> (B, D): the attention part of one K10 launch (the
        encoder takes all three parts of that launch)."""
        d = x.shape[1]
        return K.graph_pool(seg, x, self.score(x))[:, 2 * d:]


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
    """``num_layers`` LSTM cells; the carry holds (c, h) per layer."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.cells = nn.ModuleList(
            LSTMCell(in_dim if layer == 0 else hidden_dim, hidden_dim)
            for layer in range(num_layers))

    def forward(self, carry: Carry, x: torch.Tensor
                ) -> Tuple[Carry, torch.Tensor]:
        new_carry: List[Tuple[torch.Tensor, torch.Tensor]] = []
        inp = x
        for cell, layer_carry in zip(self.cells, carry):
            layer_carry, inp = cell(layer_carry, inp)
            new_carry.append(layer_carry)
        return tuple(new_carry), inp


class SequenceDecoder(nn.Module):
    def __init__(self, context_dim: int, hidden_dim: int = 128,
                 num_layers: int = 2, max_seq_len: int = 16,
                 min_rank: float = 1.0):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.num_layers = num_layers
        self.max_seq_len = max_seq_len
        self.min_rank = min_rank
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

    def _rank_head(self, out: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.out_dense1(out))
        log_rank = torch.clamp(self.out_dense2(y), -2.0, 10.0)
        return torch.exp(log_rank)[:, 0]

    def _length_head(self, context: torch.Tensor) -> torch.Tensor:
        return self.len_dense2(F.relu(self.len_dense1(context)))

    def _initial_head(self, context: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.init_dense1(context))
        return F.softplus(self.init_dense2(y)) + self.min_rank

    def generate(self, context: torch.Tensor, min_rank: float = 1.0):
        """Autoregressive ("free") decode: (schedule (B, T), lengths (B,),
        init (B, 1))."""
        T = self.max_seq_len
        lengths = torch.clamp(
            torch.argmax(self._length_head(context), dim=-1) + 1, 1, T)
        init_rank = self._initial_head(context)
        carry = self._init_carry(context)
        cur = init_rank[:, 0]
        preds = []
        for _ in range(T):
            emb = self.embed_rank(cur[:, None])
            carry, out = self.lstm(carry, torch.cat([emb, context], dim=-1))
            cur = self._rank_head(out)
            preds.append(cur)
        schedule = torch.clamp(torch.stack(preds, dim=1), min=min_rank)
        return schedule, lengths, init_rank
