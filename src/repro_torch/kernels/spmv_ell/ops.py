"""ELL SpMV: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``repro/kernels/spmv_ell/spmv_ell.py::spmv_ell_pallas``. The
kernel (``repro_torch/csrc/spmv_ell.cu``) is bound by bytes on the card:
it streams the col/val tables once, in tiles that bulk copies stage in
shared memory (the plan is :func:`repro_torch.kernels.ell_tile_plan`, and
:func:`repro_torch.kernels.ell_block_tile_plan` for a block),
and gathers ``x`` through L2, since ``x`` does not fit in shared memory
at the main path's sizes. See the source for the design.

Two forms: a vector ``x`` of ``[n_cols]`` (the one-vector kernel,
counted in ``spmv_ell.launches``), and a row-major block ``X`` of
``[n_cols, k]``, what ``jax.vmap`` over a column axis makes of the TPU
kernel (the k-column kernel, counted in ``spmv_ell.block_launches``):
column ``j`` of its result is bitwise the one-vector result of
``X[:, j]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (ell_block_tile_plan, ell_tile_plan, is_fake,
                                 launch, lib, note, on_cuda, require,
                                 require_aligned, shape_only)
from repro_torch.sparse.segment import take_fill


def ell_row_sums(col: torch.Tensor, val: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``Σ_w val[r, w]·x[col[r, w]]`` in float32 (slots whose col is out of
    range add 0), for a vector ``x`` or each column of a block: a block's
    products are laid out ``[k, n_rows, width]`` so that every column
    reduces a contiguous row of ``width`` products, as the vector does."""
    if x.dim() == 1:
        return (val * take_fill(x, col, 0)).sum(dim=1)
    g = take_fill(x, col, 0).permute(2, 0, 1).contiguous()
    return (val * g).sum(dim=2).t().contiguous()


def spmv_ell_ref(col: torch.Tensor, val: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``y[r] = Σ_w val[r, w]·x[col[r, w]]``, with slots
    whose col is out of range contributing 0; ``Y[r, j]`` of ``X[:, j]``
    for a block."""
    return ell_row_sums(col, val, x).to(x.dtype)


def spmv_ell(col: torch.Tensor, val: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV of a vector ``x`` [n_cols] or a row-major block
    ``x`` [n_cols, k]: the kernel on CUDA tensors, the plain version on CPU
    ones, the shape-only path on fake ones."""
    n_rows, width = col.shape
    block = x.dim() == 2
    k = x.shape[1] if block else 1
    name = "spmv_ell_block" if block else "spmv_ell"
    nbytes = 8 * n_rows * width + 4 * k * (x.shape[0] + n_rows)
    out_shape = (n_rows, k) if block else (n_rows,)
    if is_fake(col, val, x):
        if width == 0 or n_rows == 0:
            return x.new_zeros(out_shape)
        return shape_only(spmv_ell, name, nbytes, x.new_empty(out_shape),
                          block=block)
    if not on_cuda("spmv_ell", col, val, x):
        return spmv_ell_ref(col, val, x)
    from repro_torch.kernels._build import check

    require("spmv_ell col", col, torch.int32, (n_rows, width))
    require("spmv_ell val", val, torch.float32, (n_rows, width))
    require("spmv_ell x", x, torch.float32, (x.shape[0],) + out_shape[1:])
    if block and k == 0:
        raise ValueError("spmv_ell x: a block needs at least one column")
    for nm, t in (("col", col), ("val", val), ("x", x)):
        require_aligned(f"spmv_ell {nm}", t)
    y = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    if width == 0 or n_rows == 0:
        return y.zero_()
    if block:
        check(launch(x, lib().repro_spmv_ell_block_f32, col.data_ptr(),
                     val.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows,
                     width, x.shape[0], k, *ell_block_tile_plan(width, k)),
              name)
        spmv_ell.block_launches += 1
    else:
        rows, stages, smem = ell_tile_plan(width)
        check(launch(x, lib().repro_spmv_ell_f32, col.data_ptr(),
                     val.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows,
                     width, x.shape[0], rows, stages, smem), name)
        spmv_ell.launches += 1
    note(name, nbytes)
    return y


spmv_ell.launches = 0
spmv_ell.block_launches = 0
spmv_ell.fake_launches = 0
spmv_ell.block_fake_launches = 0
