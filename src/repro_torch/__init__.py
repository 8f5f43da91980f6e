"""PyTorch/CUDA port of the parallel graph-Laplacian solver.

The layout mirrors ``repro`` (the JAX package): ``sparse/``, ``kernels/``,
``core/`` and ``graphs/`` for the solver; ``models/recsys``, ``configs/``,
``data/``, ``optim/`` and ``runtime/`` for DeepFM serving and training.
Entry points run on the CUDA device unless the caller names another one
(``device="cpu"``); the hand-written Hopper kernels (the reference's four
Pallas kernels and the embedding bag's backward) live in ``csrc/`` and
are built with ``nvcc`` on first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
