"""Fused weighted-Jacobi sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/jacobi/jacobi.py::jacobi_step_pallas``. The
kernel (``repro_torch/csrc/jacobi.cu``) is bound by bytes: one pass over
(col, val, x, b, deg) per sweep instead of an SpMV and three elementwise
passes, with the tables staged in shared memory by bulk copies (the plan
is :func:`repro_torch.kernels.ell_tile_plan`, and
:func:`repro_torch.kernels.ell_block_tile_plan` for a block). It writes a
new buffer, never ``x`` in place.

Two forms, as ``spmv_ell``'s: vectors ``x``, ``b`` of ``[n]`` (counted
in ``jacobi_step.launches``), and row-major blocks ``[n, k]`` (the
k-column kernel, the TPU kernel under ``jax.vmap``; counted in
``jacobi_step.block_launches``), each column bitwise the one-vector
sweep of that column.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (ell_block_tile_plan, ell_tile_plan, is_fake,
                                 launch, lib, note, on_cuda, require,
                                 require_aligned, shape_only)
from repro_torch.kernels.spmv_ell.ops import ell_row_sums


def jacobi_step_ref(col, val, x, b, deg, omega: float = 2.0 / 3.0):
    """Plain version: ``x + ω·inv·(b − (deg⊙x − A_ell x))`` with
    ``inv = 1/deg`` where ``deg > 0`` and 0 elsewhere; on blocks ``deg``
    and ``inv`` act on every column."""
    ax = ell_row_sums(col, val, x)
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-30), 0.0)
    if x.dim() == 2:
        deg, inv = deg[:, None], inv[:, None]
    r = b - (deg * x - ax)
    return (x + omega * inv * r).to(x.dtype)


def jacobi_step(col, val, x, b, deg, omega: float = 2.0 / 3.0):
    """One fused sweep of a vector ``x`` [n] or a row-major block ``x``
    [n, k] (``b`` of the same shape): the kernel on CUDA tensors, the
    plain version on CPU ones, the shape-only path on fake ones."""
    n, width = col.shape
    block = x.dim() == 2
    k = x.shape[1] if block else 1
    name = "jacobi_block" if block else "jacobi"
    nbytes = 8 * n * width + 12 * k * n + 4 * n
    shape = (n, k) if block else (n,)
    if is_fake(col, val, x, b, deg):
        return shape_only(jacobi_step, name, nbytes, x.new_empty(shape),
                          block=block)
    if not on_cuda("jacobi_step", col, val, x, b, deg):
        return jacobi_step_ref(col, val, x, b, deg, omega)
    from repro_torch.kernels._build import check

    require("jacobi col", col, torch.int32, (n, width))
    require("jacobi val", val, torch.float32, (n, width))
    for nm, t in (("x", x), ("b", b)):
        require(f"jacobi {nm}", t, torch.float32, shape)
    require("jacobi deg", deg, torch.float32, (n,))
    if block and k == 0:
        raise ValueError("jacobi x: a block needs at least one column")
    # a block's rows of B are read as vectors of up to 4 floats, as X's
    for nm, t in (("col", col), ("val", val), ("x", x)) + (
            (("b", b),) if block else ()):
        require_aligned(f"jacobi {nm}", t)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    if block:
        check(launch(x, lib().repro_jacobi_block_f32, col.data_ptr(),
                     val.data_ptr(), x.data_ptr(), b.data_ptr(),
                     deg.data_ptr(), out.data_ptr(), n, width, k,
                     float(omega), *ell_block_tile_plan(width, k)), name)
        jacobi_step.block_launches += 1
    else:
        rows, stages, smem = ell_tile_plan(width)
        check(launch(x, lib().repro_jacobi_f32, col.data_ptr(),
                     val.data_ptr(), x.data_ptr(), b.data_ptr(),
                     deg.data_ptr(), out.data_ptr(), n, width, float(omega),
                     rows, stages, smem), name)
        jacobi_step.launches += 1
    note(name, nbytes)
    return out


jacobi_step.launches = 0
jacobi_step.block_launches = 0
jacobi_step.fake_launches = 0
jacobi_step.block_fake_launches = 0
