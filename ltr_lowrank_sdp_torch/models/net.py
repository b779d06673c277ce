"""GNN encoder + rank-schedule predictor (PyTorch), for inference.

The counterpart of ``ltr_lowrank_sdp_tpu/models/net.py``, whose architecture
contract matches the reference (``model/net.py``): encoders for the 16/5/17
feature sets, ``num_gnn_layers`` x GATv2 (heads x (hidden/heads), concat,
edge features, residual + LayerNorm + LeakyReLU(0.2)), graph embedding =
concat[mean-pool, max-pool, attention-pool, encoded-global] of dim
3*hidden + global_dim, and the autoregressive LSTM sequence decoder.

On the GPU every GATv2 layer is one launch of K9 and the three poolings are
one launch of K10; the destination CSR of the edges and the graphs' chunk
layout are built once per ``predict`` and shared by the layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels as K
from .gatv2 import GATv2Conv
from .layers import (LAYER_NORM_EPS, AttentionPooling, EdgeEncoder,
                     GlobalEncoder, NodeEncoder, SequenceDecoder)


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
        self.node_encoder = NodeEncoder(cfg.node_in_dim, h, cfg.norm_type)
        self.edge_encoder = EdgeEncoder(cfg.edge_in_dim, cfg.edge_dim,
                                        cfg.norm_type)
        self.global_encoder = GlobalEncoder(cfg.global_in_dim, cfg.global_dim,
                                            cfg.norm_type)
        self.convs = nn.ModuleList(
            GATv2Conv(h, h // cfg.num_heads, cfg.num_heads, cfg.edge_dim)
            for _ in range(cfg.num_gnn_layers))
        self.norms = nn.ModuleList(
            nn.LayerNorm(h, eps=LAYER_NORM_EPS)
            for _ in range(cfg.num_gnn_layers))
        self.attn_pool = AttentionPooling(h, h // 2)

    def forward(self, x, graph: K.EdgeCSR, edge_attr, seg: K.GraphSegments,
                global_attr) -> torch.Tensor:
        """-> (B, 3 hidden + global_dim) graph embeddings."""
        x = self.node_encoder(x)
        e = self.edge_encoder(edge_attr)
        g = self.global_encoder(global_attr)
        for conv, norm in zip(self.convs, self.norms):
            x_res = x
            x = F.leaky_relu(norm(conv(x, graph, e)), 0.2)
            x = x + x_res
        pooled = K.graph_pool(seg, x, self.attn_pool.score(x))
        return torch.cat([pooled, g], dim=-1)


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
        )

    @torch.no_grad()
    def predict(self, x, edge_index, edge_attr, batch, global_attr,
                num_graphs: int, min_rank: float = 1.0):
        """Inference: (schedule (B, T) floats, lengths (B,)).  ``batch``
        (N,) is each node's graph id, sorted; ``edge_index`` (2, E) holds
        node ids of the whole batch."""
        graph = K.EdgeCSR.from_edge_index(edge_index, x.shape[0])
        seg = K.GraphSegments.from_batch(batch, num_graphs)
        context = self.encoder(x, graph, edge_attr, seg, global_attr)
        schedule, lengths, _ = self.decoder.generate(context,
                                                     min_rank=min_rank)
        return schedule, lengths


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
