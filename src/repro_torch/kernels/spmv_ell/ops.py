"""ELL SpMV: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/spmv_ell/spmv_ell.py::spmv_ell_pallas``. The
kernel (``repro_torch/csrc/spmv_ell.cu``) is bound by bytes on the card:
it streams the col/val tables once, in tiles that bulk copies stage in
shared memory (the plan is :func:`repro_torch.kernels.ell_tile_plan`),
and gathers ``x`` through L2, since ``x`` does not fit in shared memory
at the main path's sizes. See the source for the design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (ell_tile_plan, is_fake, launch, lib, note,
                                 on_cuda, require, require_aligned,
                                 shape_only)
from repro_torch.sparse.segment import take_fill


def spmv_ell_ref(col: torch.Tensor, val: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``y[r] = Σ_w val[r, w]·x[col[r, w]]``, with slots
    whose col is out of range contributing 0."""
    return (val * take_fill(x, col, 0)).sum(dim=1).to(x.dtype)


def spmv_ell(col: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV: the kernel on CUDA tensors, the plain version on CPU ones,
    the shape-only path on fake ones."""
    n_rows, width = col.shape
    nbytes = 8 * n_rows * width + 4 * x.shape[0] + 4 * n_rows
    if is_fake(col, val, x):
        if width == 0 or n_rows == 0:
            return x.new_zeros(n_rows)
        return shape_only(spmv_ell, "spmv_ell", nbytes, x.new_empty(n_rows))
    if not on_cuda("spmv_ell", col, val, x):
        return spmv_ell_ref(col, val, x)
    from repro_torch.kernels._build import check

    require("spmv_ell col", col, torch.int32, (n_rows, width))
    require("spmv_ell val", val, torch.float32, (n_rows, width))
    require("spmv_ell x", x, torch.float32, (x.shape[0],))
    for name, t in (("col", col), ("val", val), ("x", x)):
        require_aligned(f"spmv_ell {name}", t)
    rows, stages, smem = ell_tile_plan(width)
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if width == 0 or n_rows == 0:
        return y.zero_()
    check(launch(x, lib().repro_spmv_ell_f32, col.data_ptr(), val.data_ptr(),
                 x.data_ptr(), y.data_ptr(), n_rows, width, x.shape[0],
                 rows, stages, smem), "spmv_ell")
    spmv_ell.launches += 1
    note("spmv_ell", nbytes)
    return y


spmv_ell.launches = 0
spmv_ell.fake_launches = 0
