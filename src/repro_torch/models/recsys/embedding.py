"""Embedding substrate (torch port of ``repro.models.recsys.embedding``).

An embedding bag is a sum-semiring SpMV with one-hot rows. The unweighted
bag sum goes through the hand-written kernel
(``repro_torch.kernels.embedding_bag``) on the card; where ``table``
requires grad, through ``BagSum``, whose backward is the deterministic
backward kernel (over a ``bag_grad_plan`` that callers summing several
tables over the same ids build once and pass in). Weighted bags keep the reference's composition (gather,
scale, masked sum) and its autograd, as the JAX package has no kernel for
them.

On a mesh (``table`` a DTensor, as the dry-run places it: rows split over
``"model"``, the batch over the DP axes) the unweighted bag sum runs under
``local_map``: each rank sums its own rows, ids outside them counting 0
(the kernel's rule for ids out of range), and the result is a partial sum
over the rank's row split, which DTensor all-reduces where it is used.
"""

from __future__ import annotations

import torch

from repro_torch.core.graph import _M32, _mul32
from repro_torch.sparse.segment import take_fill


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum", plan=None) -> torch.Tensor:
    """table [V, d]; indices [..., H] (out-of-range = padding) -> [..., d].

    Multi-hot bags reduce over the trailing H axis. ``mode``: sum|mean.
    ``plan``: ``kernels.embedding_bag.bag_grad_plan`` of ``indices``
    reshaped to ``[-1, H]`` for ``V`` rows, which the unweighted bag sum's
    backward then uses instead of building its own.
    """
    from repro_torch.kernels.embedding_bag import BagSum, embedding_bag_kernel

    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: unknown mode {mode!r}")
    if _is_dtensor(table) and weights is None and mode == "sum":
        return _embedding_bag_mesh(table, indices)
    V, d = table.shape
    valid = None if weights is None and mode == "sum" else \
        (indices >= 0) & (indices < V)
    if weights is None:
        bags = indices.reshape(-1, indices.shape[-1])  # a view, no copy
        if table.requires_grad and torch.is_grad_enabled():
            out = BagSum.apply(table, bags, plan)
        else:
            out = embedding_bag_kernel(table, bags)
        out = out.reshape(*indices.shape[:-1], d)
    else:
        vecs = take_fill(table, indices, 0) * weights[..., None]
        out = torch.where(valid[..., None], vecs, 0).sum(dim=-2)
    if mode == "mean":
        out = out / valid.sum(dim=-1, keepdim=True).clamp(min=1)
    return out


def hashed_lookup(table: torch.Tensor, raw_ids: torch.Tensor,
                  n_hashes: int = 2) -> torch.Tensor:
    """Hashing-trick lookup: the sum of ``n_hashes`` independently hashed
    rows. The reference's uint32 arithmetic is done on int64 with 32-bit
    masks (torch has no ``>>`` on uint32), bit for bit."""
    V = table.shape[0]
    out = 0
    x = raw_ids.long() & _M32
    for i in range(n_hashes):
        x = _mul32(x ^ (x >> 16), 0x45D9F3B + 2 * i + 1)
        x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
        h = (x ^ (x >> 16)) % V
        out = out + table.index_select(0, h.reshape(-1)).reshape(
            *h.shape, *table.shape[1:])
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _embedding_bag_mesh(table, indices):
    """The bag sum of a DTensor ``table`` whose rows may be split over some
    mesh dims, for DTensor ``indices`` (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.sharding import local_shape_offset

    mesh = table.device_mesh
    tpl, ipl = table.placements, indices.placements
    rows_split = [isinstance(p, Shard) and p.dim == 0 for p in tpl]
    out_pl = [Partial() if split else p for split, p in zip(rows_split, ipl)]
    grad_pl = [p if split else (Partial() if isinstance(q, Shard)
                                else Replicate())
               for split, p, q in zip(rows_split, tpl, ipl)]
    v0 = local_shape_offset(table.shape, mesh, tpl)[1][0]

    def local(tl, il):
        ids = torch.where((il >= v0) & (il < v0 + tl.shape[0]), il - v0, -1)
        return embedding_bag(tl, ids.to(il.dtype))

    return local_map(local, out_placements=out_pl,
                     in_placements=(list(tpl), list(ipl)),
                     in_grad_placements=(grad_pl, list(ipl)),
                     device_mesh=mesh)(table, indices)
