"""Gradient compression: torch port of ``repro.optim.compress``.

int8 quantisation with a per-tensor scale, and error feedback
(Karimireddy et al. 2019). ``compressed_psum`` stands in for the
data-parallel gradient all-reduce over one axis of a
``repro_torch.dist`` mesh: each rank all-gathers the others' int8 values
(4× fewer bytes than float32) and their scales, and sums the dequantised
tensors in rank order along the axis. The reference calls it inside
``shard_map`` with an axis name; here the axis's subgroup of the mesh
(``ProcessMesh.axis_group``) carries the all-gathers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize_int8(x: torch.Tensor):
    """``(q int8, scale float32 scalar)`` with ``x ≈ q · scale``;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _gather(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` of every rank along ``axis``, stacked in axis order."""
    group = mesh.axis_group(axis)
    n = dist.get_world_size(group)
    src = t.cpu() if mesh.staged else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src.contiguous(), group=group)
    mesh.count_collective(src, staged=mesh.staged)
    return torch.stack(parts).to(t.device)


def _dequantized_sum(mesh, q: torch.Tensor, scale: torch.Tensor,
                     axis: str) -> torch.Tensor:
    qs = _gather(mesh, q, axis)                      # [P, ...] int8
    ss = _gather(mesh, scale.reshape(1), axis)[:, 0]  # [P] float32
    return torch.tensordot(ss, qs.float(), dims=([0], [0]))


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh`` along ``axis``, each
    rank's ``x`` sent as int8 with its scale."""
    q, scale = quantize_int8(x)
    return _dequantized_sum(mesh, q, scale, axis)


def ef_compress_grad(g: torch.Tensor, residual: torch.Tensor, mesh,
                     axis: str):
    """Error-feedback compressed gradient sync over ``axis``: returns
    ``(mean of the ranks' sent gradients, this rank's new residual)``."""
    corrected = g + residual
    q, scale = quantize_int8(corrected)
    new_residual = corrected - dequantize_int8(q, scale)
    summed = _dequantized_sum(mesh, q, scale, axis)
    return summed / mesh.axis_sizes()[axis], new_residual
