"""equiformer-v2 [gnn]: n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8
equivariance=SO(2)-eSCN [arXiv:2306.12059; assigned pool]; torch port of
``repro.configs.equiformer_v2``.

Big-graph shapes stream edges in chunks and recompute each layer on the
backward pass (remat), as the reference's overrides say. The dry-run
case (``gnn_common.make_gnn_dryrun_case``) is the family's: edges split
over every mesh axis, node states replicated. (The reference's case
also constrains the big graphs' [N, 49, C] irreps to N over the DP axes
and C over ``"model"``; the port's rank program keeps them replicated,
which its peak shows.)
"""

import dataclasses

from repro_torch.configs.gnn_common import register_gnn
from repro_torch.models.gnn.equiformer import (EquiformerConfig,
                                               equiformer_forward,
                                               init_equiformer)
from repro_torch.models.gnn.so3 import n_coeffs

FULL = EquiformerConfig(n_layers=12, channels=128, l_max=6, m_max=2,
                        n_heads=8, d_out=47)

# per-shape working-set controls (edge streaming + remat on huge cells)
_SHAPE_OVERRIDES = dict(
    ogb_products=dict(edge_chunk_size=131072, remat=True),
    minibatch_lg=dict(edge_chunk_size=65536, remat=True),
    full_graph_sm=dict(remat=True),
)


def make_model(shape_name, d_feat):
    if shape_name == "smoke":
        cfg = EquiformerConfig(n_layers=2, channels=8, l_max=2, m_max=1,
                               n_heads=2, d_node_in=d_feat, d_out=4)
    else:
        cfg = dataclasses.replace(FULL, d_node_in=d_feat,
                                  **_SHAPE_OVERRIDES.get(shape_name, {}))
    return cfg, init_equiformer, equiformer_forward


def _per_edge(cfg, m_product_flops):
    K = n_coeffs(cfg.l_max)
    C = cfg.channels
    sum_sq = sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1))
    return (2 * K * 50                      # SH eval at K sample points
            + 2 * K * sum_sq                # sampled Wigner per-l matmuls
            + 4 * sum_sq * C                # rotate + rotate back
            + 2 * ((cfg.l_max + 1) * C) ** 2  # m=0 mixing
            + sum(m_product_flops * ((cfg.l_max + 1 - m) * C) ** 2
                  for m in range(1, cfg.m_max + 1)))


def flops(cfg, n_nodes, n_edges):
    """The reference's count, kept as it is: it books each m > 0 group's
    four (nl·C)² products at 4·(nl·C)²."""
    per_node = 2 * n_coeffs(cfg.l_max) * cfg.channels ** 2
    return 3.0 * cfg.n_layers * (n_edges * _per_edge(cfg, 4)
                                 + n_nodes * per_node)


def flops_executed(cfg, n_nodes, n_edges):
    """The same count with each m > 0 group's four products at 2·(nl·C)²
    each (8·(nl·C)²), and, under ``remat``, the forward recomputed on the
    backward pass (4 passes of the forward's work, not 3)."""
    per_node = 2 * n_coeffs(cfg.l_max) * cfg.channels ** 2
    passes = 4.0 if cfg.remat else 3.0
    return passes * cfg.n_layers * (n_edges * _per_edge(cfg, 8)
                                    + n_nodes * per_node)


register_gnn("equiformer-v2", make_model, flops, needs_pos=True,
             describe=__doc__)
