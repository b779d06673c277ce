"""GNN encoder + rank-schedule predictor (PyTorch).

The counterpart of ``ltr_lowrank_sdp_tpu/models/net.py``, whose architecture
contract matches the reference (``model/net.py``): encoders for the 16/5/17
feature sets, ``num_gnn_layers`` x GATv2 (heads x (hidden/heads), concat,
edge features, residual + LayerNorm + LeakyReLU(0.2) + dropout), graph
embedding = concat[mean-pool, max-pool, attention-pool, encoded-global] of dim
3*hidden + global_dim, and the autoregressive LSTM sequence decoder.

On the GPU every GATv2 layer is one launch of K9 and the three poolings are
one launch of K10 (K11 and K12 in the backward pass of training); the
destination CSR of the edges and the graphs' chunk layout are built once per
call and shared by the layers.  ``forward`` is the training call (dropout in
training mode, teacher forcing); ``predict`` the free-running inference.
:func:`init_params` draws a fresh model from Flax's initialisers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels as K
from .gatv2 import GATv2Conv
from .layers import (LAYER_NORM_EPS, AttentionPooling, EdgeEncoder,
                     GlobalEncoder, LSTMCell, NodeEncoder, SequenceDecoder,
                     dropout, keep_scale)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    node_in_dim: int = 16
    edge_in_dim: int = 5
    global_in_dim: int = 17
    hidden_dim: int = 128
    edge_dim: int = 64
    global_dim: int = 64
    num_gnn_layers: int = 4
    num_heads: int = 4
    decoder_hidden_dim: int = 128
    decoder_num_layers: int = 2
    max_seq_len: int = 16
    dropout: float = 0.1
    norm_type: str = "layer"

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        return ModelConfig(**{k: v for k, v in d.items() if k in known})


class GNNEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_dim
        self.p = cfg.dropout
        self.heads = cfg.num_heads
        self.node_encoder = NodeEncoder(cfg.node_in_dim, h, cfg.norm_type,
                                        cfg.dropout)
        self.edge_encoder = EdgeEncoder(cfg.edge_in_dim, cfg.edge_dim,
                                        cfg.norm_type, cfg.dropout)
        self.global_encoder = GlobalEncoder(cfg.global_in_dim, cfg.global_dim,
                                            cfg.norm_type, cfg.dropout)
        self.convs = nn.ModuleList(
            GATv2Conv(h, h // cfg.num_heads, cfg.num_heads, cfg.edge_dim)
            for _ in range(cfg.num_gnn_layers))
        self.norms = nn.ModuleList(
            nn.LayerNorm(h, eps=LAYER_NORM_EPS)
            for _ in range(cfg.num_gnn_layers))
        self.attn_pool = AttentionPooling(h, h // 2, cfg.dropout)

    def edge_fill(self, e: torch.Tensor,
                  envelope: Optional[Tuple[int, int]] = None,
                  generator: Optional[torch.Generator] = None):
        """The self-loops' edge feature: the mean of the encoded edges
        ``e``, or, with ``envelope = (n_pad, e_pad)``, the mean over the
        JAX package's padded edge envelope, whose ``e_pad - E`` rows of zeros
        each encode to the edge encoder's output on zeros (``GATv2Conv``
        averages all ``e_pad`` rows, ``gatv2.py:55-60``)."""
        if envelope is None:
            return (torch.mean(e, dim=0) if e.shape[0] > 0
                    else e.new_zeros(e.shape[1]))
        e_pad = envelope[1]
        if e_pad < e.shape[0]:
            raise ValueError(f"edge envelope {e_pad} < {e.shape[0]} edges")
        dead = self.edge_encoder.mlp.zero_rows_sum(e_pad - e.shape[0],
                                                   generator)
        return (torch.sum(e, dim=0) + dead) / e_pad

    def forward(self, x, graph: K.EdgeCSR, edge_attr, seg: K.GraphSegments,
                global_attr, envelope: Optional[Tuple[int, int]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> (B, 3 hidden + global_dim) graph embeddings."""
        p = self.p if self.training else 0.0
        x = self.node_encoder(x, generator)
        e = self.edge_encoder(edge_attr, generator)
        g = self.global_encoder(global_attr, generator)
        fill = self.edge_fill(e, envelope, generator)
        for conv, norm in zip(self.convs, self.norms):
            x_res = x
            keep = keep_scale((graph.n_slots, self.heads), p, generator,
                              x.device)
            x = F.leaky_relu(norm(conv(x, graph, e, fill, keep)), 0.2)
            x = dropout(x, p, generator) + x_res
        pooled = K.graph_pool(seg, x, self.attn_pool.score(x),
                              self.attn_pool.keep(x.shape[0], generator,
                                                  x.device))
        return torch.cat([pooled, g], dim=-1)


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """``model`` in eval mode (no dropout) for the block, then back."""
    was = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was)


class RankSchedulePredictor(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = GNNEncoder(cfg)
        self.decoder = SequenceDecoder(
            context_dim=3 * cfg.hidden_dim + cfg.global_dim,
            hidden_dim=cfg.decoder_hidden_dim,
            num_layers=cfg.decoder_num_layers,
            max_seq_len=cfg.max_seq_len,
            min_rank=1.0,
            dropout=cfg.dropout,
        )

    def forward(self, x, edge_index, edge_attr, batch, global_attr,
                num_graphs: int, target_schedule=None, target_mask=None,
                teacher_forcing_ratio=0.5, *,
                generator: Optional[torch.Generator] = None,
                coins: Optional[torch.Tensor] = None,
                envelope: Optional[Tuple[int, int]] = None):
        """The training call (``net.py:117-129``): (predictions (B, T),
        length_logits (B, T), init_rank (B, 1)).  Dropout acts in training
        mode, its masks drawn from ``generator``; the decoder's teacher
        forcing takes ``coins`` (T,) or draws them from ``generator`` (see
        :meth:`SequenceDecoder.forward`).  ``envelope = (n_pad, e_pad)`` is
        the JAX collate's padded node / edge envelope of this batch, which
        moves the self-loops' edge feature (``GNNEncoder.edge_fill``).
        ``batch`` (N,) is each node's graph id, sorted."""
        graph = K.EdgeCSR.from_edge_index(edge_index, x.shape[0])
        seg = K.GraphSegments.from_batch(batch, num_graphs)
        context = self.encoder(x, graph, edge_attr, seg, global_attr,
                               envelope, generator)
        return self.decoder(context, target_schedule, target_mask,
                            teacher_forcing_ratio, generator=generator,
                            coins=coins)

    @torch.no_grad()
    def predict(self, x, edge_index, edge_attr, batch, global_attr,
                num_graphs: int, min_rank: float = 1.0, *,
                envelope: Optional[Tuple[int, int]] = None):
        """Inference: (schedule (B, T) floats, lengths (B,)).  ``batch``
        (N,) is each node's graph id, sorted; ``edge_index`` (2, E) holds
        node ids of the whole batch; ``envelope`` as in :meth:`forward`.
        No dropout, whatever the mode."""
        graph = K.EdgeCSR.from_edge_index(edge_index, x.shape[0])
        seg = K.GraphSegments.from_batch(batch, num_graphs)
        with eval_mode(self):
            context = self.encoder(x, graph, edge_attr, seg, global_attr,
                                   envelope)
            schedule, lengths, _ = self.decoder.generate(context,
                                                         min_rank=min_rank)
        return schedule, lengths


def _lecun_normal_(weight: torch.Tensor, generator) -> None:
    """Flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``, on an ``nn.Linear`` weight (out, in)."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from the initialiser Flax gives it: Dense kernels
    ``lecun_normal``, biases zero, LayerNorm scales one; an LSTM cell's four
    input kernels ``lecun_normal`` and four hidden kernels each
    ``orthogonal``; GATv2's ``att`` (1, H, C) ``glorot_uniform`` (fan in H,
    fan out C).  ``generator`` lives on the parameters' device."""
    cells = [m for m in model.modules() if isinstance(m, LSTMCell)]
    in_cells = {id(lin) for c in cells for lin in (c.ih, c.hh)}
    for cell in cells:
        h = cell.hh.weight.shape[1]
        for gate in range(4):
            rows = slice(gate * h, (gate + 1) * h)
            _lecun_normal_(cell.ih.weight[rows], generator)
            nn.init.orthogonal_(cell.hh.weight[rows], generator=generator)
        nn.init.zeros_(cell.hh.bias)
    for mod in model.modules():
        if isinstance(mod, nn.Linear) and id(mod) not in in_cells:
            _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, GATv2Conv):
            _, heads, ch = mod.att.shape
            limit = math.sqrt(6.0 / (heads + ch))
            nn.init.uniform_(mod.att, -limit, limit, generator=generator)


RankPredictor = RankSchedulePredictor


def get_valid_schedule(schedule, lengths, min_rank: int = 1):
    """Round + clamp + cut to predicted length (reference
    ``predict``/``get_valid_schedule``, ``model/net.py:286-343``)."""
    if isinstance(schedule, torch.Tensor):
        schedule = schedule.detach().cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu().numpy()
    schedule = np.maximum(np.round(np.asarray(schedule)), min_rank).astype(int)
    lengths = np.asarray(lengths)
    return [
        schedule[i, : int(lengths[i])].tolist()
        for i in range(schedule.shape[0])
    ]


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
