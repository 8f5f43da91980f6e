"""Multi-hot embedding bag: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/embedding_bag/embedding_bag.py::
embedding_bag_pallas`` (with its padding wrapper ``ops.py::
embedding_bag_kernel``). The kernel (``repro_torch/csrc/embedding_bag.cu``)
is bound by bytes on the card: it streams the ids in tiles that bulk
copies stage in shared memory (the plan is
:func:`repro_torch.kernels.bag_tile_plan`), gathers each bag's rows through
L1/L2 and writes ``[n_bags, d]`` by bulk copies of whole output tiles, with
no padded copy of the table or the batch. Ids that do not start on a
16-byte boundary (a view such as ``idx[3:]``) are read with plain loads
inside the same kernel. It has no backward yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bag_tile_plan, on_cuda, require, stream_of
from repro_torch.sparse.segment import take_fill


def embedding_bag_ref(table: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[b] = Σ_h table[indices[b, h]]`` summed in
    float32, ids outside ``[0, V)`` contributing 0."""
    vecs = take_fill(table, indices, 0)                  # [B, hot, d]
    return vecs.sum(dim=-2, dtype=torch.float32).to(table.dtype)


def embedding_bag_kernel(table: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """table [V, d] float32, indices [n_bags, hot] int32 -> [n_bags, d]:
    the kernel on CUDA tensors, the plain version on CPU ones."""
    if not on_cuda("embedding_bag", table, indices):
        return embedding_bag_ref(table, indices)
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "embedding_bag: the CUDA kernel has no backward yet")
    from repro_torch.kernels._build import check, library

    n_vocab, d = table.shape
    n_bags, hot = indices.shape
    require("embedding_bag table", table, torch.float32, (n_vocab, d))
    require("embedding_bag indices", indices, torch.int32, (n_bags, hot))
    out = torch.empty((n_bags, d), dtype=torch.float32, device=table.device)
    if n_bags == 0 or hot == 0 or d == 0:
        return out.zero_()
    bags, stages, smem = bag_tile_plan(hot, d)
    lib = library()
    with torch.cuda.device(table.device):
        check(lib.repro_embedding_bag_f32(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(), n_bags,
            hot, d, n_vocab, bags, stages, smem, stream_of(table)),
            "embedding_bag")
    embedding_bag_kernel.launches += 1
    return out


embedding_bag_kernel.launches = 0
