"""GATv2 graph attention convolution with edge features (PyTorch).

The counterpart of ``ltr_lowrank_sdp_tpu/models/gatv2.py`` with the same
semantics, which are the reference encoder's (``model/net.py:100-112``:
heads=4, concat, edge_dim, add_self_loops, share_weights=False) and not
PyG's: per directed edge j -> i,

    e_ij   = a_h^T LeakyReLU_0.2(W_t x_i + W_s x_j + W_e e_feat)
    alpha  = segment-softmax of e over incoming edges of i (+1e-16)
    out_i  = concat_h sum_j alpha_ij (W_s x_j)_h

A self-loop is appended for every node (existing loops and duplicate edges
stay), with the mean of the encoded edge features as its feature (zeros when
there is no edge; in training the encoder passes the mean over the JAX
package's padded edge envelope instead, see ``net.GNNEncoder``); the three
projections are Dense layers with bias and there is no output bias.  The
projections are matrix products; the scores, the softmax, the attention
dropout and the aggregation are one launch of K9 on the GPU
(:func:`~ltr_lowrank_sdp_torch.ops.kernels.gatv2_softmax_agg`), whose backward
is K11; their plain versions on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import kernels as K
from ..ops.kernels import EdgeCSR, segment_softmax  # noqa: F401


class GATv2Conv(nn.Module):
    def __init__(self, in_dim: int, out_channels: int, heads: int = 4,
                 edge_dim: int = 64):
        super().__init__()
        self.heads = heads
        self.out_channels = out_channels
        hc = heads * out_channels
        self.lin_src = nn.Linear(in_dim, hc)
        self.lin_dst = nn.Linear(in_dim, hc)
        self.lin_edge = nn.Linear(edge_dim, hc)
        self.att = nn.Parameter(torch.empty(1, heads, out_channels))

    def forward(self, x: torch.Tensor, graph: EdgeCSR,
                edge_attr: torch.Tensor,
                fill: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (n, in_dim), ``graph`` the edges with their self-loops,
        edge_attr (E, edge_dim) the encoded edge features, ``fill``
        (edge_dim,) the self-loops' feature (default: the mean of edge_attr),
        ``keep`` (E + n, heads) the attention dropout's keep-scale in the
        CSR's slot order -> (n, heads * out_channels)."""
        if fill is None:
            fill = (torch.mean(edge_attr, dim=0) if edge_attr.shape[0] > 0
                    else edge_attr.new_zeros(edge_attr.shape[1]))
        return K.gatv2_softmax_agg(graph, self.lin_src(x), self.lin_dst(x),
                                   self.lin_edge(edge_attr),
                                   self.lin_edge(fill), self.att[0], keep)
