"""PNA (Corso et al., arXiv:2004.05718): Principal Neighbourhood
Aggregation; torch port of ``repro.models.gnn.pna``.

Aggregators {mean, max, min, std} × scalers {identity, amplification,
attenuation} (assigned config: n_layers=4, d_hidden=75). The sums go
through the scatter-sum kernel (``common.scatter_sum``), max and min
through ``repro_torch.sparse.segment``'s row-wise reductions.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.gnn.common import (GraphBatch, edge_max, edge_min,
                                           gather_dst, gather_src,
                                           in_degrees, init_mlp, mlp_apply,
                                           scatter_sum)


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_node_in: int = 16
    d_out: int = 1
    avg_degree: float = 8.0    # delta = E[log(deg+1)] of the training graphs


def init_pna(cfg: PNAConfig, generator: torch.Generator,
             device=None) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (see
    ``init_mlp``) onto ``device`` (default: the CUDA card)."""
    d = cfg.d_hidden
    p = dict(embed=init_mlp([cfg.d_node_in, d], generator, device),
             readout=init_mlp([d, d, cfg.d_out], generator, device),
             pre_mlps=[], post_mlps=[])
    for _ in range(cfg.n_layers):
        p["pre_mlps"].append(init_mlp([2 * d, d], generator, device))
        p["post_mlps"].append(init_mlp([13 * d, d], generator, device))
    return p


def _aggregate(g: GraphBatch, msgs):
    n = g.n_nodes
    valid = g.edge_valid[:, None]
    m0 = torch.where(valid, msgs, 0)
    s = scatter_sum(g, m0)
    cnt = in_degrees(g, msgs.dtype)
    mean = s / torch.clamp(cnt, min=1)
    big = torch.finfo(msgs.dtype).max
    mx = edge_max(torch.where(valid, msgs, -big), g.receivers, n)
    mn = edge_min(torch.where(valid, msgs, big), g.receivers, n)
    mx = torch.where(cnt > 0, mx, 0)
    mn = torch.where(cnt > 0, mn, 0)
    sq = scatter_sum(g, m0 * m0)
    # eps inside sqrt: d/dx sqrt(x) -> inf at 0 would NaN the backward pass
    # for isolated / constant-message nodes. torch.maximum, not clamp: at
    # a variance of exactly 0 (one in-edge) it halves the gradient, as
    # jnp.maximum does
    var = sq / torch.clamp(cnt, min=1) - mean * mean
    std = torch.sqrt(torch.maximum(var, var.new_zeros(())) + 1e-8)
    return mean, mx, mn, std, cnt[:, 0]


def pna_forward(cfg: PNAConfig, params: dict, g: GraphBatch) -> torch.Tensor:
    h = mlp_apply(params["embed"], g.node_feat)
    delta = math.log(cfg.avg_degree + 1.0)
    for pre, post in zip(params["pre_mlps"], params["post_mlps"]):
        msgs = mlp_apply(pre, torch.cat([gather_dst(g, h), gather_src(g, h)],
                                        dim=-1), final_act=True)
        mean, mx, mn, std, deg = _aggregate(g, msgs)
        logd = torch.log(deg + 1.0)[:, None]
        amp = logd / delta
        att = delta / torch.clamp(logd, min=1e-3)
        feats = []
        for agg in (mean, mx, mn, std):
            feats += [agg, agg * amp, agg * att]
        h = h + mlp_apply(post, torch.cat([h] + feats, dim=-1))
    return mlp_apply(params["readout"], h)
