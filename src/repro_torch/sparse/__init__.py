"""Sparse substrate: padded COO, ELL, segment reductions, matvec dispatch
(the reference's ``repro.sparse`` exports)."""

from repro_torch.sparse.coo import (COO, coo_from_dense, extract_diag,
                                    row_sums, spmm, spmv)
from repro_torch.sparse.ell import ELL, coo_to_ell, ell_spmv_ref
from repro_torch.sparse.matvec import (MATVEC_BACKENDS, hybrid_spmv,
                                       laplacian_matvec, select_ell_width,
                                       split_hybrid)
from repro_torch.sparse.segment import (segment_argmax_lex,
                                        segment_argmin_lex, segment_max,
                                        segment_min, segment_sum)

__all__ = [
    "COO", "coo_from_dense", "spmv", "spmm", "row_sums", "extract_diag",
    "ELL", "coo_to_ell", "ell_spmv_ref",
    "MATVEC_BACKENDS", "hybrid_spmv", "laplacian_matvec", "select_ell_width",
    "split_hybrid",
    "segment_sum", "segment_max", "segment_min", "segment_argmax_lex",
    "segment_argmin_lex",
]
