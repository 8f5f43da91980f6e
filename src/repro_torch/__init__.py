"""PyTorch/CUDA port of the parallel graph-Laplacian solver.

The layout mirrors ``repro`` (the JAX package): ``sparse/``, ``kernels/``,
``core/`` and ``graphs/``. Entry points run on the CUDA device unless the
caller names another one (``device="cpu"``); the three hand-written
Hopper kernels live in ``csrc/`` and are built with ``nvcc`` on first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
