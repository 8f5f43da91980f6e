from repro_torch.models.gnn.common import init_mlp, mlp_apply

__all__ = ["init_mlp", "mlp_apply"]
