from repro_torch.models.gnn.common import GraphBatch, segment_mean_max
from repro_torch.models.gnn.egnn import EGNNConfig, egnn_forward, init_egnn
from repro_torch.models.gnn.equiformer import (EquiformerConfig,
                                               equiformer_forward,
                                               init_equiformer)
from repro_torch.models.gnn.meshgraphnet import (MeshGraphNetConfig, init_mgn,
                                                 mgn_forward)
from repro_torch.models.gnn.pna import PNAConfig, init_pna, pna_forward

__all__ = [
    "GraphBatch", "segment_mean_max",
    "MeshGraphNetConfig", "init_mgn", "mgn_forward",
    "EGNNConfig", "init_egnn", "egnn_forward",
    "PNAConfig", "init_pna", "pna_forward",
    "EquiformerConfig", "init_equiformer", "equiformer_forward",
]
