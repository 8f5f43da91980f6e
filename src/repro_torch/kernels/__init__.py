"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper runs its CUDA kernel on CUDA tensors and its plain version on
CPU tensors, and only there; it counts its kernel launches in a plain int
attribute, ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the card, False when every tensor is on
    the CPU; raises on anything else (mixed devices, other backends)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"{name}: tensors must all be on CUDA or all on the "
                     f"CPU, got {sorted(kinds)}")


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
