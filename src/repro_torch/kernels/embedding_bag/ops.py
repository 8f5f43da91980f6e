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
are sorted by id once a batch (:func:`bag_grad_plan`, a stable
``torch.sort``; DeepFM's two tables share one plan) and each id's run is
summed in a fixed order; every row of the ``[V, d]`` output is written
once, untouched rows with zeros. :class:`BagSum` is the
``torch.autograd.Function`` that pairs the two.

Message passing: with bags of one id the same two kernels are a row
gather and its scatter-sum. ``BagSum.apply(x, senders.view(-1, 1),
plan)`` is ``x[senders]`` (ids outside ``[0, N)`` giving 0) with the
backward kernel as its gradient, and :class:`ScatterSum` is the
deterministic ``Σ_{e: receivers[e] = r} msgs[e]`` with the forward
kernel as its gradient; neither adds with float atomics, so a training
step gives the same bits every time (``index_add_``, autograd's gather
backward on CUDA, would not). :class:`ScatterAdd` adds such a sum into a
running one in place (the backward's accumulate form), as a caller that
sums edge chunks needs.

Rows of ``d`` floats take one of two paths in each kernel
(:func:`repro_torch.kernels.bag_path`): ``"narrow"`` (DeepFM's rows) or
``"wide"`` (d >= 32: the GNNs' rows, a row split over a warp's lanes).
Each wrapper counts its launches by path in ``<wrapper>.paths``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import (bag_path, bag_tile_plan, is_fake, launch,
                                 lib, note, on_cuda, require,
                                 require_aligned, shape_only)
from repro_torch.kernels._build import check
from repro_torch.sparse.segment import sorted_segment_sum, take_fill

# sorted slots a warp of the backward kernel (kChunk in its source)
BAG_GRAD_CHUNK = 256
# floats of a tile of output rows that one warp of the backward zeroes
_BAG_GRAD_TILE_FLOATS = 4096
# sorted slots a block of the backward's wide path (kSeg in its source): a
# run longer than this (a hub) is summed in parts, a block each
BAG_WIDE_SEG = 32
_I32_MAX = torch.iinfo(torch.int32).max


def _c_ints(name: str, **values: int) -> None:
    """Raise unless every value fits the kernel's ``int`` arguments (a
    larger one would wrap in ``ctypes``); sizes that can pass 2³¹ − 1 are
    ``long long`` in the kernels."""
    for key, v in values.items():
        if not 0 <= v <= _I32_MAX:
            raise ValueError(f"{name}: {key} = {v} does not fit the "
                             "kernel's int32 argument")


def embedding_bag_ref(table: torch.Tensor,
                      indices: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[b] = Σ_h table[indices[b, h]]`` summed in
    float32 (a float64 table in float64), ids outside ``[0, V)``
    contributing 0."""
    vecs = take_fill(table, indices, 0)                  # [B, hot, d]
    acc = torch.promote_types(table.dtype, torch.float32)
    return vecs.sum(dim=-2, dtype=acc).to(table.dtype)


def embedding_bag_kernel(table: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """table [V, d] float32, indices [n_bags, hot] int32 -> [n_bags, d]:
    the kernel on CUDA tensors, the plain version on CPU ones. Builds no
    autograd graph: :class:`BagSum` differentiates it. Fake tensors take
    the shape-only path (the distinct rows read counted as at most one a
    slot)."""
    n_vocab, d = table.shape
    n_bags, hot = indices.shape
    nbytes = 4 * n_bags * hot + 4 * n_bags * d + 4 * d * min(n_bags * hot,
                                                             n_vocab)
    if is_fake(table, indices):
        if n_bags == 0 or hot == 0 or d == 0:
            return table.new_zeros((n_bags, d))
        return shape_only(embedding_bag_kernel, "embedding_bag", nbytes,
                          table.new_empty((n_bags, d)))
    if not on_cuda("embedding_bag", table, indices):
        return embedding_bag_ref(table, indices)
    require("embedding_bag table", table, torch.float32, (n_vocab, d))
    require("embedding_bag indices", indices, torch.int32, (n_bags, hot))
    _c_ints("embedding_bag", hot=hot, d=d, n_vocab=n_vocab)
    out = torch.empty((n_bags, d), dtype=torch.float32, device=table.device)
    if n_bags == 0 or hot == 0 or d == 0:
        return out.zero_()
    path = bag_path(d)
    if path == "wide":
        check(launch(table, lib().repro_embedding_bag_rows_f32,
                      table.data_ptr(), indices.data_ptr(), out.data_ptr(),
                      n_bags, hot, d, n_vocab), "embedding_bag")
    else:
        bags, stages, smem = bag_tile_plan(hot, d)
        check(launch(table, lib().repro_embedding_bag_f32, table.data_ptr(),
                      indices.data_ptr(), out.data_ptr(), n_bags, hot, d,
                      n_vocab, bags, stages, smem), "embedding_bag")
    embedding_bag_kernel.launches += 1
    embedding_bag_kernel.paths[path] += 1
    note("embedding_bag", nbytes)
    return out


embedding_bag_kernel.launches = 0
embedding_bag_kernel.fake_launches = 0
embedding_bag_kernel.paths = {"narrow": 0, "wide": 0}


@dataclasses.dataclass(frozen=True)
class BagGradPlan:
    """The sorted slots of one ``[n_bags, hot]`` id batch, for the
    backward: ``sorted_ids`` [n_slots] int32, the ids sorted stably with
    every id outside ``[0, n_vocab)`` keyed ``n_vocab`` (so those sort
    last), and ``rows`` [n_slots] int32, each sorted slot's bag (its
    ``g_out`` row, ``slot // hot``). Any table of ``n_vocab`` rows that the
    same ids index can use it."""

    sorted_ids: torch.Tensor
    rows: torch.Tensor
    n_vocab: int
    hot: int


def bag_grad_plan_ref(indices: torch.Tensor, n_vocab: int) -> BagGradPlan:
    """Plain version of :func:`bag_grad_plan`: the keyed ids sorted by one
    stable ``torch.sort`` (int64 slot indices), the rows divided out."""
    hot = indices.shape[1]
    flat = indices.reshape(-1)
    key = torch.where((flat >= 0) & (flat < n_vocab), flat, n_vocab)
    sorted_ids, order = torch.sort(key.to(torch.int32), stable=True)
    rows = torch.div(order, max(hot, 1), rounding_mode="floor")
    return BagGradPlan(sorted_ids, rows.to(torch.int32), n_vocab, hot)


def bag_grad_plan(indices: torch.Tensor, n_vocab: int) -> BagGradPlan:
    """Sort the slots of ``indices`` [n_bags, hot] by id for the backward
    of bag sums over tables of ``n_vocab`` rows: on CUDA ids the kernel
    (``csrc/bag_grad_plan.cu``: a radix sort over only the bits of ``[0,
    n_vocab]``, int32 rows), on CPU ones the plain version; the same bits
    either way. Counts every build in ``bag_grad_plan.builds`` and the
    kernel's launches in ``bag_grad_plan.launches``."""
    if indices.dim() != 2:
        raise ValueError(f"bag_grad_plan: indices must be [n_bags, hot], "
                         f"got shape {tuple(indices.shape)}")
    if not 0 < n_vocab < _I32_MAX:
        raise ValueError(f"bag_grad_plan: n_vocab {n_vocab} out of range")
    bag_grad_plan.builds += 1
    n_bags, hot = indices.shape
    n_slots = n_bags * hot
    if is_fake(indices) and n_slots:
        return shape_only(bag_grad_plan, "bag_grad_plan", 12 * n_slots,
                          BagGradPlan(indices.new_empty(n_slots),
                                      indices.new_empty(n_slots), n_vocab,
                                      hot))
    if not on_cuda("bag_grad_plan", indices) or n_slots == 0:
        return bag_grad_plan_ref(indices, n_vocab)
    require("bag_grad_plan indices", indices, torch.int32, (n_bags, hot))
    if n_slots > _I32_MAX:
        raise ValueError(f"bag_grad_plan: {n_slots} slots, more than int32")
    fn = lib().repro_bag_grad_plan_i32
    temp_bytes = ctypes.c_longlong(0)       # the sort's scratch: asked first
    check(fn(None, n_slots, hot, n_vocab, None, None, None, None, None,
             ctypes.byref(temp_bytes), None), "bag_grad_plan")
    dev = indices.device
    keys_in, rows_in, sorted_ids, rows = (
        torch.empty(n_slots, dtype=torch.int32, device=dev) for _ in range(4))
    temp = torch.empty(max(temp_bytes.value, 1), dtype=torch.uint8,
                       device=dev)
    check(launch(indices, fn, indices.data_ptr(), n_slots, hot, n_vocab,
                  keys_in.data_ptr(), rows_in.data_ptr(),
                  sorted_ids.data_ptr(), rows.data_ptr(), temp.data_ptr(),
                  ctypes.byref(temp_bytes)), "bag_grad_plan")
    bag_grad_plan.launches += 1
    note("bag_grad_plan", 12 * n_slots)
    return BagGradPlan(sorted_ids, rows, n_vocab, hot)


bag_grad_plan.builds = 0
bag_grad_plan.launches = 0
bag_grad_plan.fake_launches = 0


def _checked_plan(plan: BagGradPlan | None, indices: torch.Tensor,
                  n_vocab: int) -> BagGradPlan:
    """``plan``, or a new one for ``indices``; raises if ``plan`` cannot
    be that of ``indices`` for ``n_vocab`` rows (its ids are not read)."""
    if plan is None:
        return bag_grad_plan(indices, n_vocab)
    n_slots = indices.shape[0] * indices.shape[1]
    if (plan.n_vocab != n_vocab or plan.hot != indices.shape[1]
            or plan.sorted_ids.shape != (n_slots,)
            or plan.sorted_ids.device != indices.device):
        raise ValueError(
            f"embedding_bag_backward: the plan (n_vocab {plan.n_vocab}, hot "
            f"{plan.hot}, {plan.sorted_ids.shape[0]} slots on "
            f"{plan.sorted_ids.device}) is not one of these ids (n_vocab "
            f"{n_vocab}, shape {tuple(indices.shape)} on {indices.device})")
    return plan


def bag_grad_layout(n_slots: int, n_vocab: int, d: int) -> tuple[int, int,
                                                                 int]:
    """The backward kernel's layout: ``(chunk, tile_log2, scratch_bytes)``.
    The sorted slots go in chunks of ``BAG_GRAD_CHUNK``, one a warp; the
    output rows in tiles of ``2**tile_log2`` rows, one a warp in the pass
    that zeroes untouched rows: the least power of two of rows that holds
    ``_BAG_GRAD_TILE_FLOATS`` floats at width ``d``, from 32 to 1024 rows
    (one to 32 words of the touched-row bitmap). The scratch holds two
    partial rows a chunk, then (at a 16-byte boundary) the bitmap, a bit a
    row in 32-bit words."""
    rows = -(-_BAG_GRAD_TILE_FLOATS // d)
    tile_log2 = min(10, max(5, (rows - 1).bit_length()))
    words_at = -(-(-(-n_slots // BAG_GRAD_CHUNK) * 2 * d * 4) // 16) * 16
    return BAG_GRAD_CHUNK, tile_log2, words_at + 4 * -(-n_vocab // 32)


def bag_wide_layout(n_slots: int, n_vocab: int, d: int) -> tuple[int, int,
                                                                 int]:
    """The backward kernel's layout on the wide path: ``(seg, tile_log2,
    scratch_bytes)``. The sorted slots go in blocks of ``BAG_WIDE_SEG``
    (the length past which a run is a hub, summed a block at a time), one
    warp a block and slab of columns; the pass that zeroes untouched rows
    takes tiles of ``2**tile_log2`` rows a warp and slab, the least power
    of two of rows that holds ``_BAG_GRAD_TILE_FLOATS`` floats of a
    512-float slab (of the row, where it is narrower), from 1 to 64 rows.
    The scratch holds two partial rows a block, then (at a 16-byte
    boundary) the bitmap, a bit a row in 32-bit words."""
    rows = -(-_BAG_GRAD_TILE_FLOATS // max(1, min(d, 512)))
    tile_log2 = min(6, (rows - 1).bit_length())
    words_at = -(-(-(-n_slots // BAG_WIDE_SEG) * 2 * d * 4) // 16) * 16
    return BAG_WIDE_SEG, tile_log2, words_at + 4 * -(-n_vocab // 32)


def embedding_bag_backward_ref(g_out: torch.Tensor, indices: torch.Tensor,
                               n_vocab: int,
                               plan: BagGradPlan | None = None, *,
                               acc: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Plain version of the backward: ``g_table[v] = Σ_{(b, h): indices[b,
    h] = v} g_out[b]``, ``[n_vocab, d]``, rows no valid id touches 0. A
    deterministic sorted segment sum (``sparse.segment``) over ``plan``'s
    order (built here when none is given): each row's slots in slot
    order, from 0, the same bits with a plan or without one. In float32
    (float64 ``g_out`` in float64). With ``acc`` (the accumulate form),
    ``acc.add_(g_table)``: returns ``acc``."""
    plan = _checked_plan(plan, indices, n_vocab)
    dtype = torch.promote_types(g_out.dtype, torch.float32)
    rows = g_out.to(dtype).index_select(0, plan.rows.long())
    sums = sorted_segment_sum(rows, plan.sorted_ids, n_vocab)
    return sums if acc is None else acc.add_(sums)


def _backward_bytes(n_slots: int, n_bags: int, d: int, n_vocab: int,
                    accumulate: bool) -> int:
    """The bytes the backward must move, from shapes: the ids, g_out, and
    the whole ``[n_vocab, d]`` output written, or in the accumulate form
    the touched rows read and written (at most one a slot)."""
    rows = 2 * min(n_slots, n_vocab) if accumulate else n_vocab
    return 4 * n_slots + 4 * n_bags * d + 4 * rows * d


def embedding_bag_backward(g_out: torch.Tensor, indices: torch.Tensor,
                           n_vocab: int, plan: BagGradPlan | None = None, *,
                           acc: torch.Tensor | None = None,
                           _out: torch.Tensor | None = None) -> torch.Tensor:
    """g_out [n_bags, d] float32, indices [n_bags, hot] int32 -> the
    table's gradient [n_vocab, d]: the kernel on CUDA tensors, the plain
    version on CPU ones. ``plan`` is :func:`bag_grad_plan` of ``indices``
    (built here when none is given). Same bits on every launch.

    ``acc`` (a contiguous float32 ``[n_vocab, d]`` running sum on the same
    device) takes the accumulate form: each touched row ``v`` becomes
    ``acc[v] + s_v`` in place, ``s_v`` the row's sum as the wide path
    computes it, and ``acc`` is returned; rows no valid id touches are
    neither read nor written. It always takes the wide path, so from d =
    32 on (``bag_path``) its bits are ``acc.add_(embedding_bag_backward(
    ...))``'s.

    ``_out`` (a contiguous float32 ``[n_vocab, d]`` on the same device)
    receives the result in place of a new tensor; it exists to check that
    the kernel writes every row. Fake tensors take the shape-only
    path."""
    if acc is not None and _out is not None:
        raise ValueError("embedding_bag_backward: acc and _out exclude "
                         "each other")
    if is_fake(g_out, indices):
        n_bags, hot = indices.shape
        d = g_out.shape[-1]
        out = acc if acc is not None else (
            g_out.new_empty((n_vocab, d)) if _out is None else _out)
        if n_bags * hot == 0 or d == 0:
            return out if acc is not None else out.zero_()
        _checked_plan(plan, indices, n_vocab)   # as the kernel's path does
        return shape_only(embedding_bag_backward, "embedding_bag_backward",
                          _backward_bytes(n_bags * hot, n_bags, d, n_vocab,
                                          acc is not None), out)
    if not on_cuda("embedding_bag_backward", g_out, indices):
        got = embedding_bag_backward_ref(g_out, indices, n_vocab, plan,
                                         acc=acc)
        return got if _out is None else _out.copy_(got)

    n_bags, hot = indices.shape
    d = g_out.shape[1] if g_out.dim() == 2 else -1
    require("embedding_bag_backward g_out", g_out, torch.float32,
            (n_bags, d))
    if indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag_backward indices: expected "
                        f"torch.int32, got {indices.dtype}")
    _c_ints("embedding_bag_backward", d=d, n_vocab=n_vocab)
    plan = _checked_plan(plan, indices, n_vocab)
    if acc is not None:
        require("embedding_bag_backward acc", acc, torch.float32,
                (n_vocab, d))
        if acc.device != g_out.device:
            raise ValueError("embedding_bag_backward: acc is on "
                             f"{acc.device}, g_out on {g_out.device}")
        out = acc
    elif _out is None:
        out = torch.empty((n_vocab, d), dtype=torch.float32,
                          device=g_out.device)
    else:
        require("embedding_bag_backward _out", _out, torch.float32,
                (n_vocab, d))
        require_aligned("embedding_bag_backward _out", _out)
        if _out.device != g_out.device:
            raise ValueError("embedding_bag_backward: _out is on "
                             f"{_out.device}, g_out on {g_out.device}")
        out = _out
    n_slots = n_bags * hot
    if n_slots == 0 or d == 0:
        return out if acc is not None else out.zero_()
    path = "wide" if acc is not None else bag_path(d)
    if path == "wide":
        chunk, tile_log2, scratch_bytes = bag_wide_layout(n_slots, n_vocab,
                                                          d)
    else:
        chunk, tile_log2, scratch_bytes = bag_grad_layout(n_slots, n_vocab,
                                                          d)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8,
                          device=g_out.device)
    ptrs = (plan.sorted_ids.data_ptr(), plan.rows.data_ptr(),
            g_out.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch_bytes, n_slots, d, n_vocab, chunk, tile_log2)
    if path == "wide":
        check(launch(g_out, lib().repro_embedding_bag_backward_rows_f32,
                      *ptrs, int(acc is not None)), "embedding_bag_backward")
    else:
        check(launch(g_out, lib().repro_embedding_bag_backward_f32, *ptrs),
              "embedding_bag_backward")
    embedding_bag_backward.launches += 1
    embedding_bag_backward.paths[
        "wide_accumulate" if acc is not None else path] += 1
    note("embedding_bag_backward",
         _backward_bytes(n_slots, n_bags, d, n_vocab, acc is not None))
    return out


embedding_bag_backward.launches = 0
embedding_bag_backward.fake_launches = 0
embedding_bag_backward.paths = {"narrow": 0, "wide": 0, "wide_accumulate": 0}


class BagSum(torch.autograd.Function):
    """The unweighted bag sum with a gradient for ``table``:
    ``BagSum.apply(table [V, d], indices [n_bags, hot] int32, plan=None)``,
    ``plan`` a :func:`bag_grad_plan` of ``indices`` for ``V`` rows that the
    backward uses (without one it builds its own). Forward and backward
    run the kernels on CUDA tensors (and raise if one fails to build or
    launch), the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, indices: torch.Tensor,
                plan: BagGradPlan | None = None):
        ctx.save_for_backward(indices)
        ctx.n_vocab = table.shape[0]
        ctx.plan = plan
        return embedding_bag_kernel(table, indices)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        (indices,) = ctx.saved_tensors
        # e.g. the first-order term's gradient arrives as a stride-0 expand
        return (embedding_bag_backward(g_out.contiguous(), indices,
                                       ctx.n_vocab, ctx.plan), None, None)


class ScatterSum(torch.autograd.Function):
    """The scatter-sum of message passing: ``ScatterSum.apply(msgs [E, d],
    indices [E, 1] int32, n_rows, plan=None)`` -> ``[n_rows, d]``, row r
    the sum of the messages whose index is r (in edge order, from 0),
    rows no index in ``[0, n_rows)`` names 0. Its forward is the bag
    backward kernel over ``plan`` (:func:`bag_grad_plan` of ``indices``
    for ``n_rows`` rows; built here when none is given), its backward the
    bag forward kernel over the same ids: the gradient of each message is
    its row's. Kernels on CUDA tensors, plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, msgs: torch.Tensor, indices: torch.Tensor, n_rows: int,
                plan: BagGradPlan | None = None):
        ctx.save_for_backward(indices)
        out = embedding_bag_backward(msgs.contiguous(), indices, n_rows,
                                     plan)
        # the plain version's sum is a slice of a longer buffer: a view,
        # which autograd would not let a caller add to in place
        return out if out._base is None else out.clone()

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        (indices,) = ctx.saved_tensors
        return (embedding_bag_kernel(g_out.contiguous(), indices), None,
                None, None)


class ScatterAdd(torch.autograd.Function):
    """:class:`ScatterSum` added into a running sum, in place:
    ``ScatterAdd.apply(acc [n_rows, d], msgs [E, d], indices [E, 1]
    int32, n_rows, plan=None)`` -> ``acc``, each row r increased by the
    sum of the messages whose index is r (from rows of 32 floats on, the
    bits of ``acc.add_(ScatterSum.apply(msgs, ...))``). Its forward is the
    bag backward kernel's accumulate form, which reads and writes only
    the touched rows; the gradient of ``acc`` is the incoming one, that of
    each message its row's (the bag forward kernel)."""

    @staticmethod
    def forward(ctx, acc: torch.Tensor, msgs: torch.Tensor,
                indices: torch.Tensor, n_rows: int,
                plan: BagGradPlan | None = None):
        ctx.save_for_backward(indices)
        ctx.mark_dirty(acc)
        return embedding_bag_backward(msgs.contiguous(), indices, n_rows,
                                      plan, acc=acc)

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        (indices,) = ctx.saved_tensors
        return (g_out, embedding_bag_kernel(g_out.contiguous(), indices),
                None, None, None)
