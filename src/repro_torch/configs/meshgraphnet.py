"""meshgraphnet [gnn]: n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2
[arXiv:2010.03409; assigned pool]; torch port of
``repro.configs.meshgraphnet``."""

import dataclasses

from repro_torch.configs.gnn_common import register_gnn
from repro_torch.models.gnn.meshgraphnet import (MeshGraphNetConfig,
                                                 init_mgn, mgn_forward)

FULL = MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2,
                          d_edge_in=8, d_out=47)


def make_model(shape_name, d_feat):
    if shape_name == "smoke":
        cfg = MeshGraphNetConfig(n_layers=2, d_hidden=24, mlp_layers=2,
                                 d_node_in=d_feat, d_edge_in=8, d_out=4)
    else:
        cfg = dataclasses.replace(FULL, d_node_in=d_feat)
    return cfg, init_mgn, mgn_forward


def flops(cfg, n_nodes, n_edges):
    d = cfg.d_hidden
    per_layer = 2 * n_edges * (3 * d * d + 2 * d * d) \
        + 2 * n_nodes * (2 * d * d + 2 * d * d)
    enc = 2 * n_nodes * cfg.d_node_in * d + 2 * n_edges * cfg.d_edge_in * d
    return 3.0 * (cfg.n_layers * per_layer + enc)  # fwd+bwd ≈ 3× fwd


register_gnn("meshgraphnet", make_model, flops, needs_edge_feat=True,
             describe=__doc__)
