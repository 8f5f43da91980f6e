"""Fused weighted-Jacobi sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/jacobi/jacobi.py::jacobi_step_pallas``. The
kernel (``repro_torch/csrc/jacobi.cu``) is bound by bytes: one pass over
(col, val, x, b, deg) per sweep instead of an SpMV and three elementwise
passes, with the tables staged in shared memory by bulk copies (the plan
is :func:`repro_torch.kernels.ell_tile_plan`). It writes a new buffer,
never ``x`` in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (ell_tile_plan, is_fake, launch, lib, note,
                                 on_cuda, require, require_aligned,
                                 shape_only)
from repro_torch.sparse.segment import take_fill


def jacobi_step_ref(col, val, x, b, deg, omega: float = 2.0 / 3.0):
    """Plain version: ``x + ω·inv·(b − (deg⊙x − A_ell x))`` with
    ``inv = 1/deg`` where ``deg > 0`` and 0 elsewhere."""
    ax = (val * take_fill(x, col, 0)).sum(dim=1)
    r = b - (deg * x - ax)
    inv = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1e-30), 0.0)
    return (x + omega * inv * r).to(x.dtype)


def jacobi_step(col, val, x, b, deg, omega: float = 2.0 / 3.0):
    """One fused sweep: the kernel on CUDA tensors, the plain version on
    CPU ones, the shape-only path on fake ones."""
    n, width = col.shape
    nbytes = 8 * n * width + 4 * x.shape[0] + 12 * n
    if is_fake(col, val, x, b, deg):
        return shape_only(jacobi_step, "jacobi", nbytes, x.new_empty(n))
    if not on_cuda("jacobi_step", col, val, x, b, deg):
        return jacobi_step_ref(col, val, x, b, deg, omega)
    from repro_torch.kernels._build import check

    require("jacobi col", col, torch.int32, (n, width))
    require("jacobi val", val, torch.float32, (n, width))
    for name, t in (("x", x), ("b", b), ("deg", deg)):
        require(f"jacobi {name}", t, torch.float32, (n,))
    for name, t in (("col", col), ("val", val), ("x", x)):
        require_aligned(f"jacobi {name}", t)
    rows, stages, smem = ell_tile_plan(width)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    check(launch(x, lib().repro_jacobi_f32, col.data_ptr(), val.data_ptr(),
                 x.data_ptr(), b.data_ptr(), deg.data_ptr(), out.data_ptr(),
                 n, width, float(omega), rows, stages, smem), "jacobi_step")
    jacobi_step.launches += 1
    note("jacobi", nbytes)
    return out


jacobi_step.launches = 0
jacobi_step.fake_launches = 0
