"""Fused Alg 2 vote reduction: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/agg_vote/agg_vote.py::vote_reduce_pallas``. The
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
from repro_torch.sparse.segment import take_fill

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
