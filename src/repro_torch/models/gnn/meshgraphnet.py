"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode;
torch port of ``repro.models.gnn.meshgraphnet``.

15 message-passing layers, d_hidden=128, 2-hidden-layer MLPs with residual
edge+node updates and sum aggregation — the assigned config verbatim.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn.common import (GraphBatch, gather_dst, gather_src,
                                           init_mlp, mlp_apply, scatter_sum)


@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3


def _mlp_sizes(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [cfg.d_hidden]


def init_mgn(cfg: MeshGraphNetConfig, generator: torch.Generator,
             device=None) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (see
    ``init_mlp``) onto ``device`` (default: the CUDA card)."""
    def mlp(sizes, ln=True):
        return init_mlp(sizes, generator, device, layernorm_out=ln)

    p = dict(node_enc=mlp(_mlp_sizes(cfg, cfg.d_node_in)),
             edge_enc=mlp(_mlp_sizes(cfg, cfg.d_edge_in)),
             decoder=mlp([cfg.d_hidden] + [cfg.d_hidden] * cfg.mlp_layers
                         + [cfg.d_out], ln=False),
             edge_mlps=[], node_mlps=[])
    for _ in range(cfg.n_layers):
        p["edge_mlps"].append(mlp(_mlp_sizes(cfg, 3 * cfg.d_hidden)))
        p["node_mlps"].append(mlp(_mlp_sizes(cfg, 2 * cfg.d_hidden)))
    return p


def mgn_forward(cfg: MeshGraphNetConfig, params: dict,
                g: GraphBatch) -> torch.Tensor:
    x = mlp_apply(params["node_enc"], g.node_feat)
    e = mlp_apply(params["edge_enc"], g.edge_feat)
    for edge_mlp, node_mlp in zip(params["edge_mlps"], params["node_mlps"]):
        # edge update: e' = e + MLP([e, x_src, x_dst])
        e = e + mlp_apply(edge_mlp, torch.cat(
            [e, gather_src(g, x), gather_dst(g, x)], dim=-1))
        # node update: x' = x + MLP([x, Σ_in e'])
        agg = scatter_sum(g, e)
        x = x + mlp_apply(node_mlp, torch.cat([x, agg], dim=-1))
    return mlp_apply(params["decoder"], x)
