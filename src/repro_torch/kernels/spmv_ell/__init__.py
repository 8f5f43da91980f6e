from repro_torch.kernels.spmv_ell.ops import spmv_ell, spmv_ell_ref

__all__ = ["spmv_ell", "spmv_ell_ref"]
