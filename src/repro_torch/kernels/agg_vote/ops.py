"""Fused Alg 2 vote reduction: the CUDA kernel's wrappers and their plain
PyTorch versions.

Replaces ``repro/kernels/agg_vote/agg_vote.py::vote_reduce_pallas``, and
in its graph-batched form (:func:`vote_reduce_batched`) what ``jax.vmap``
over a group of graphs makes of it (the batched setup's vote rounds). The
kernel (``repro_torch/csrc/agg_vote.cu``) is bound by bytes: one pass over
the int32 (col, sq) tables per round, in the row tiles of the float ELL
kernels (bulk copies into shared memory, the plan of
:func:`repro_torch.kernels.ell_tile_plan`). The ⊕ is an integer
reduction, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (ell_tile_plan, is_fake, launch, lib, note,
                                 on_cuda, require, require_aligned,
                                 shape_only)
from repro_torch.sparse.segment import take_fill, take_groups

_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max


def _identity(n_rows: int, device):
    return (torch.full((n_rows,), _I32_MIN, dtype=torch.int32, device=device),
            torch.full((n_rows,), _I32_MAX, dtype=torch.int32, device=device))


def vote_reduce_ref(col, sq, state, *, levels: int, decided: int = 0):
    """Plain version: per ELL row, (max key, min col among the slots that
    attain it) with ``key = state[col]·(levels+2) + sq``; padding slots and
    Decided neighbours emit the identity (int32-min, int32-max)."""
    n_rows, width = col.shape
    if width == 0:
        return _identity(n_rows, col.device)
    s = take_fill(state, col, decided)
    ok = (col >= 0) & (col < state.shape[0]) & (s != decided)
    k = torch.where(ok, s * (levels + 2) + sq, _I32_MIN).to(torch.int32)
    best_k = k.max(dim=1).values
    ids = torch.where(ok & (k == best_k[:, None]), col, _I32_MAX)
    return best_k, ids.min(dim=1).values.to(torch.int32)


def vote_reduce(col, sq, state, *, levels: int, decided: int = 0):
    """(best_key, best_id) int32 per ELL row: the kernel on CUDA tensors,
    the plain version on CPU ones. Width 0 returns the identity without a
    launch; fake tensors take the shape-only path."""
    n_rows, width = col.shape
    nbytes = 8 * n_rows * width + 4 * state.shape[0] + 8 * n_rows
    if is_fake(col, sq, state):
        if width == 0 or n_rows == 0:
            return _identity(n_rows, col.device)
        return shape_only(vote_reduce, "agg_vote", nbytes,
                          (col.new_empty(n_rows), col.new_empty(n_rows)))
    if not on_cuda("vote_reduce", col, sq, state):
        return vote_reduce_ref(col, sq, state, levels=levels, decided=decided)
    from repro_torch.kernels._build import check

    if width == 0 or n_rows == 0:
        return _identity(n_rows, col.device)
    require("vote col", col, torch.int32, (n_rows, width))
    require("vote sq", sq, torch.int32, (n_rows, width))
    require("vote state", state, torch.int32, (state.shape[0],))
    for name, t in (("col", col), ("sq", sq)):
        require_aligned(f"vote {name}", t)
    rows, stages, smem = ell_tile_plan(width)
    best_k = torch.empty(n_rows, dtype=torch.int32, device=col.device)
    best_i = torch.empty(n_rows, dtype=torch.int32, device=col.device)
    check(launch(col, lib().repro_agg_vote_i32, col.data_ptr(), sq.data_ptr(),
                 state.data_ptr(), best_k.data_ptr(), best_i.data_ptr(),
                 n_rows, width, state.shape[0], int(levels), int(decided),
                 rows, stages, smem), "vote_reduce")
    vote_reduce.launches += 1
    note("agg_vote", nbytes)
    return best_k, best_i


vote_reduce.launches = 0
vote_reduce.fake_launches = 0


def _identity_batched(n_graphs: int, n_rows: int, device):
    return tuple(t.view(n_graphs, n_rows)
                 for t in _identity(n_graphs * n_rows, device))


def vote_reduce_batched_ref(col, sq, state, *, levels: int,
                            decided: int = 0):
    """Plain version of the graph-batched vote: :func:`vote_reduce_ref` of
    every graph g of a group, on its own tables ``col[g]``, ``sq[g]``
    (``[G, n_rows, width]``, each graph's own column ids) and its own
    state ``state[g]`` (``[G, n_cols]``). Returns ``[G, n_rows]`` keys and
    ids, the ids each graph's own."""
    n_graphs, n_rows, width = col.shape
    if width == 0:
        return _identity_batched(n_graphs, n_rows, col.device)
    s = take_groups(state, col, decided)
    ok = (col >= 0) & (col < state.shape[1]) & (s != decided)
    k = torch.where(ok, s * (levels + 2) + sq, _I32_MIN).to(torch.int32)
    best_k = k.max(dim=2).values
    ids = torch.where(ok & (k == best_k[..., None]), col, _I32_MAX)
    return best_k, ids.min(dim=2).values.to(torch.int32)


def vote_reduce_batched(col, sq, state, *, levels: int, decided: int = 0):
    """(best_key, best_id) int32 ``[G, n_rows]``: the vote of every graph g
    of a group on its own ``[G, n_rows, width]`` tables and ``[G,
    n_cols]`` state, in ONE launch of the graph-batched kernel on CUDA
    tensors (a row finds its graph as row // n_rows and gathers from its
    graph's state), the plain version on CPU ones. Width 0 returns the
    identity without a launch; fake tensors take the shape-only path."""
    n_graphs, n_rows, width = col.shape
    n_cols = state.shape[1]
    nbytes = n_graphs * (8 * n_rows * width + 4 * n_cols + 8 * n_rows)
    if is_fake(col, sq, state):
        if width == 0 or n_rows == 0:
            return _identity_batched(n_graphs, n_rows, col.device)
        return shape_only(vote_reduce_batched, "agg_vote", nbytes,
                          (col.new_empty(n_graphs, n_rows),
                           col.new_empty(n_graphs, n_rows)))
    if not on_cuda("vote_reduce_batched", col, sq, state):
        return vote_reduce_batched_ref(col, sq, state, levels=levels,
                                       decided=decided)
    from repro_torch.kernels._build import check

    if width == 0 or n_rows == 0 or n_graphs == 0:
        return _identity_batched(n_graphs, n_rows, col.device)
    require("vote col", col, torch.int32, (n_graphs, n_rows, width))
    require("vote sq", sq, torch.int32, (n_graphs, n_rows, width))
    require("vote state", state, torch.int32, (n_graphs, n_cols))
    for name, t in (("col", col), ("sq", sq)):
        require_aligned(f"vote {name}", t)
    if max(n_graphs * n_rows, n_graphs * n_cols) > _I32_MAX:
        raise ValueError(f"vote_reduce_batched: {n_graphs} graphs of "
                         f"{n_rows} rows and {n_cols} columns pass int32")
    rows, stages, smem = ell_tile_plan(width)
    best_k = torch.empty(n_graphs, n_rows, dtype=torch.int32,
                         device=col.device)
    best_i = torch.empty_like(best_k)
    check(launch(col, lib().repro_agg_vote_batched_i32, col.data_ptr(),
                 sq.data_ptr(), state.data_ptr(), best_k.data_ptr(),
                 best_i.data_ptr(), n_graphs, n_rows, width, n_cols,
                 int(levels), int(decided), rows, stages, smem),
          "vote_reduce_batched")
    vote_reduce_batched.launches += 1
    note("agg_vote", nbytes)
    return best_k, best_i


vote_reduce_batched.launches = 0
vote_reduce_batched.fake_launches = 0
