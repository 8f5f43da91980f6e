from repro_torch.models.gnn.common import GraphBatch, init_mlp, mlp_apply

__all__ = ["GraphBatch", "init_mlp", "mlp_apply"]
