"""egnn [gnn]: n_layers=4 d_hidden=64 equivariance=E(n)
[arXiv:2102.09844; assigned pool]; torch port of ``repro.configs.egnn``."""

import dataclasses

from repro_torch.configs.gnn_common import register_gnn
from repro_torch.models.gnn.egnn import EGNNConfig, egnn_forward, init_egnn

FULL = EGNNConfig(n_layers=4, d_hidden=64, d_out=47)


def make_model(shape_name, d_feat):
    if shape_name == "smoke":
        cfg = EGNNConfig(n_layers=2, d_hidden=16, d_node_in=d_feat, d_out=4)
    else:
        cfg = dataclasses.replace(FULL, d_node_in=d_feat)
    return cfg, init_egnn, egnn_forward


def flops(cfg, n_nodes, n_edges):
    d = cfg.d_hidden
    per_layer = 2 * n_edges * ((2 * d + 1) * d + d * d + d * d + d) \
        + 2 * n_nodes * (2 * d * d + d * d)
    return 3.0 * cfg.n_layers * per_layer


register_gnn("egnn", make_model, flops, needs_pos=True, describe=__doc__)
