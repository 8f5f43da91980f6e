"""Multi-hot embedding bag: the CUDA kernels' wrappers, their plain
versions, and the differentiable bag sum.

Forward: replaces ``repro/kernels/embedding_bag/embedding_bag.py::
embedding_bag_pallas`` (with its padding wrapper ``ops.py::
embedding_bag_kernel``). The kernel (``repro_torch/csrc/embedding_bag.cu``)
is bound by bytes on the card: it streams the ids in tiles that bulk
copies stage in shared memory (the plan is
:func:`repro_torch.kernels.bag_tile_plan`), gathers each bag's rows through
L1/L2 and writes ``[n_bags, d]`` by bulk copies of whole output tiles, with
no padded copy of the table or the batch. Ids that do not start on a
16-byte boundary (a view such as ``idx[3:]``) are read with plain loads
inside the same kernel.

Backward: the table's gradient of the bag sum
(``repro_torch/csrc/embedding_bag_backward.cu``), which replaces no TPU
kernel: the reference differentiates its ``jnp.take`` composition. It is
deterministic, as the training runner's bitwise replay needs: the slots
are sorted by id once (``torch.sort``, stable) and each id's run is summed
in a fixed order. :class:`BagSum` is the ``torch.autograd.Function`` that
pairs the two.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bag_tile_plan, on_cuda, require, stream_of
from repro_torch.sparse.segment import segment_sum, take_fill

# sorted slots a piece of the backward kernel (kPiece in its source)
BAG_GRAD_PIECE = 128
_I32_MAX = torch.iinfo(torch.int32).max


def embedding_bag_ref(table: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[b] = Σ_h table[indices[b, h]]`` summed in
    float32, ids outside ``[0, V)`` contributing 0."""
    vecs = take_fill(table, indices, 0)                  # [B, hot, d]
    return vecs.sum(dim=-2, dtype=torch.float32).to(table.dtype)


def embedding_bag_kernel(table: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """table [V, d] float32, indices [n_bags, hot] int32 -> [n_bags, d]:
    the kernel on CUDA tensors, the plain version on CPU ones. Builds no
    autograd graph: :class:`BagSum` differentiates it."""
    if not on_cuda("embedding_bag", table, indices):
        return embedding_bag_ref(table, indices)
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


def embedding_bag_backward_ref(g_out: torch.Tensor, indices: torch.Tensor,
                               n_vocab: int) -> torch.Tensor:
    """Plain version of the backward: ``g_table[v] = Σ_{(b, h): indices[b,
    h] = v} g_out[b]``, ``[n_vocab, d]``, rows no valid id touches 0. A
    deterministic sorted segment sum (``sparse.segment.segment_sum``):
    each row's slots in slot order, from 0."""
    n_bags, hot = indices.shape
    d = g_out.shape[1]
    rows = g_out.float()[:, None, :].expand(n_bags, hot, d).reshape(-1, d)
    return segment_sum(rows, indices.reshape(-1), n_vocab)


def embedding_bag_backward(g_out: torch.Tensor, indices: torch.Tensor,
                           n_vocab: int) -> torch.Tensor:
    """g_out [n_bags, d] float32, indices [n_bags, hot] int32 -> the
    table's gradient [n_vocab, d]: the kernel on CUDA tensors, the plain
    version on CPU ones. Same bits on every launch."""
    if not on_cuda("embedding_bag_backward", g_out, indices):
        return embedding_bag_backward_ref(g_out, indices, n_vocab)
    from repro_torch.kernels._build import check, library

    n_bags, hot = indices.shape
    d = g_out.shape[1] if g_out.dim() == 2 else -1
    require("embedding_bag_backward g_out", g_out, torch.float32,
            (n_bags, d))
    if indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag_backward indices: expected "
                        f"torch.int32, got {indices.dtype}")
    if not 0 < n_vocab < _I32_MAX:
        raise ValueError(f"embedding_bag_backward: n_vocab {n_vocab} out "
                         "of range")
    out = torch.zeros((n_vocab, d), dtype=torch.float32, device=g_out.device)
    n_slots = n_bags * hot
    if n_slots == 0 or d == 0:
        return out
    flat = indices.reshape(-1)
    key = torch.where((flat >= 0) & (flat < n_vocab), flat, n_vocab)
    sorted_ids, order = torch.sort(key, stable=True)
    n_pieces = -(-n_slots // BAG_GRAD_PIECE)
    partial = torch.empty((n_pieces, 2, d), dtype=torch.float32,
                          device=g_out.device)
    lib = library()
    with torch.cuda.device(g_out.device):
        check(lib.repro_embedding_bag_backward_f32(
            sorted_ids.data_ptr(), order.data_ptr(), g_out.data_ptr(),
            out.data_ptr(), partial.data_ptr(), n_slots, hot, d, n_vocab,
            n_pieces, stream_of(g_out)), "embedding_bag_backward")
    embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0


class BagSum(torch.autograd.Function):
    """The unweighted bag sum with a gradient for ``table``:
    ``BagSum.apply(table [V, d], indices [n_bags, hot] int32)``. Forward
    and backward run the kernels on CUDA tensors (and raise if one fails
    to build or launch), the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, indices: torch.Tensor):
        ctx.save_for_backward(indices)
        ctx.n_vocab = table.shape[0]
        return embedding_bag_kernel(table, indices)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        (indices,) = ctx.saved_tensors
        # e.g. the first-order term's gradient arrives as a stride-0 expand
        return (embedding_bag_backward(g_out.contiguous(), indices,
                                       ctx.n_vocab), None)
