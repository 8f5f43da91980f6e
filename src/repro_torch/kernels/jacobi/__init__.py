from repro_torch.kernels.jacobi.ops import jacobi_step, jacobi_step_ref

__all__ = ["jacobi_step", "jacobi_step_ref"]
