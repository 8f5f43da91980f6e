"""PyTorch/CUDA port of the parallel graph-Laplacian solver.

The layout mirrors ``repro`` (the JAX package): ``sparse/``, ``kernels/``,
``core/`` and ``graphs/`` for the solver; ``models/recsys``, ``configs/``
and ``data/`` for DeepFM serving. Entry points run on the CUDA device
unless the caller names another one (``device="cpu"``); the four
hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc``
on first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
