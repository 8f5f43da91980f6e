"""pna [gnn]: n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=id-amp-atten [arXiv:2004.05718; assigned pool]; torch port of
``repro.configs.pna``."""

import dataclasses

from repro_torch.configs.gnn_common import register_gnn
from repro_torch.models.gnn.pna import PNAConfig, init_pna, pna_forward

FULL = PNAConfig(n_layers=4, d_hidden=75, d_out=47)


def make_model(shape_name, d_feat):
    if shape_name == "smoke":
        cfg = PNAConfig(n_layers=2, d_hidden=15, d_node_in=d_feat, d_out=4)
    else:
        cfg = dataclasses.replace(FULL, d_node_in=d_feat)
    return cfg, init_pna, pna_forward


def flops(cfg, n_nodes, n_edges):
    d = cfg.d_hidden
    per_layer = 2 * n_edges * (2 * d * d) + 2 * n_nodes * (13 * d * d) \
        + 4 * n_edges * d  # four segment reductions
    return 3.0 * cfg.n_layers * per_layer


register_gnn("pna", make_model, flops, describe=__doc__)
