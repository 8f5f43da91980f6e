"""EGNN (Satorras et al., arXiv:2102.09844): E(n)-equivariant GNN; torch
port of ``repro.models.gnn.egnn``.

4 layers, d_hidden=64 (assigned config). Messages depend only on invariants
(h_i, h_j, ‖x_i−x_j‖²); coordinate updates move along difference vectors, so
the network is exactly E(n)-equivariant — tested by conjugation with random
rotations/translations.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn.common import (GraphBatch, gather_dst, gather_src,
                                           in_degrees, init_mlp, mlp_apply,
                                           scatter_sum)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_node_in: int = 16
    d_out: int = 1
    coord_clamp: float = 100.0


def init_egnn(cfg: EGNNConfig, generator: torch.Generator,
              device=None) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (see
    ``init_mlp``) onto ``device`` (default: the CUDA card)."""
    d = cfg.d_hidden
    p = dict(embed=init_mlp([cfg.d_node_in, d], generator, device),
             readout=init_mlp([d, d, cfg.d_out], generator, device),
             edge_mlps=[], coord_mlps=[], node_mlps=[])
    for _ in range(cfg.n_layers):
        p["edge_mlps"].append(init_mlp([2 * d + 1, d, d], generator, device))
        p["coord_mlps"].append(init_mlp([d, d, 1], generator, device))
        p["node_mlps"].append(init_mlp([2 * d, d, d], generator, device))
    return p


def _clip(w: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.clip(w, -c, c)`` with its gradient: halved at a bound, as
    ``jnp.clip``'s maximum and minimum give (``torch.clamp`` passes it
    whole)."""
    return torch.minimum(torch.maximum(w, w.new_tensor(-c)), w.new_tensor(c))


def egnn_forward(cfg: EGNNConfig, params: dict, g: GraphBatch):
    """Returns (node_out [N, d_out], coords [N, 3])."""
    h = mlp_apply(params["embed"], g.node_feat)
    x = g.pos
    # Σ_j 1 over each node's valid in-edges: the same in every layer
    norm = 1.0 + in_degrees(g, x.dtype)
    for e_mlp, c_mlp, n_mlp in zip(params["edge_mlps"], params["coord_mlps"],
                                   params["node_mlps"]):
        diff = gather_dst(g, x) - gather_src(g, x)
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = mlp_apply(e_mlp, torch.cat(
            [gather_dst(g, h), gather_src(g, h), d2], dim=-1),
            final_act=True)
        # coordinate update (equivariant): x_i += Σ_j (x_i−x_j) φ_x(m_ij)
        w = _clip(mlp_apply(c_mlp, m), cfg.coord_clamp)
        x = x + scatter_sum(g, diff * w) / norm
        # node update
        agg = scatter_sum(g, m)
        h = h + mlp_apply(n_mlp, torch.cat([h, agg], dim=-1))
    return mlp_apply(params["readout"], h), x
