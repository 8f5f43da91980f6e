"""Segment reductions, gathers with fill, and the lexicographic ⊕ operators.

The JAX reference leans on three conventions that torch does not give by
default; they all live here:

* segment reductions drop ids outside ``[0, num_segments)`` (padding uses
  the sentinel id ``num_segments``);
* ``take_fill`` returns ``fill`` for out-of-range gathers, like
  ``jnp.take(mode="fill")``;
* out-of-range writes are dropped: callers scatter into a buffer one row
  longer than the output and slice the sentinel row off.

Float segment sums are deterministic on every device: the entries are
stably sorted by segment id and each segment is summed in entry order
(``torch.segment_reduce``), never with atomic ``index_add_``. On the CPU
that is exactly the order of XLA's scatter-add, so sums match the
reference bit for bit. Integer sums may use ``index_add_``: integer
addition is associative, so atomics cannot change the result. No
reduction here makes the host wait on the device.
"""

from __future__ import annotations

import torch

_I32_MAX = torch.iinfo(torch.int32).max
_DROP_CHUNK = 1024


def _big(dtype):
    return (torch.finfo(dtype).max if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def _small(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def _seg_ids(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 segment ids with every out-of-range id mapped to the sentinel."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, num_segments)


def per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v`` (one value a row) shaped to act on every column of ``x``:
    ``v`` itself for a vector ``x``, ``v[:, None]`` for a block ``[n, k]``
    (the port's form of a function the reference ``jax.vmap``s over
    columns)."""
    return v if x.dim() == 1 else v[:, None]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(0, idx)`` for in-range int64 ``idx``. Rows of 16 to
    256 bytes of a contiguous ``[n, k]`` tensor (the blocks of the
    throughput path, the setup's narrow tables) are taken through one flat
    index over the elements instead: on an H100 (torch 2.11) a 2-D
    ``index_select`` of 2.5 M such rows took ≈ 1.51 ms whatever their
    width, the flat form 0.141 ms at k = 8 float32 columns
    (``benchmarks/port_gather.py``, PERF.md). The values are the same."""
    if x.dim() != 2 or not x.is_contiguous() \
            or not 16 <= x.shape[1] * x.element_size() <= 256:
        return x.index_select(0, idx)
    k = x.shape[1]
    itype = torch.int32 if x.numel() < _I32_MAX else torch.int64
    cols = torch.arange(k, dtype=itype, device=x.device)
    flat = (idx.to(itype)[:, None] * k + cols).reshape(-1)
    return x.reshape(-1).index_select(0, flat).view(idx.shape[0], k)


def take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` along dim 0, with ``fill`` where ``idx`` is out of range."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.full(idx.shape + x.shape[1:], fill, dtype=x.dtype,
                          device=x.device)
    flat = idx.reshape(-1).long().clamp(0, n - 1)
    g = take_rows(x, flat).reshape(idx.shape + x.shape[1:])
    if x.dim() > 1:
        ok = ok.reshape(ok.shape + (1,) * (x.dim() - 1))
    return torch.where(ok, g, fill)


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows by segment id; out-of-range ids are dropped."""
    if not data.is_floating_point():
        seg = _seg_ids(ids, num_segments)
        out = data.new_zeros((num_segments + 1,) + data.shape[1:])
        return out.index_add_(0, seg, data)[:num_segments]
    return segment_sum_plan(ids, num_segments)(data)


def segment_sum_plan(ids: torch.Tensor, num_segments: int):
    """The float :func:`segment_sum` over fixed ``ids``, its sort done
    once: returns ``f(data)``, bit for bit ``segment_sum(data, ids,
    num_segments)``, for callers that sum over the same ids many times."""
    seg = _seg_ids(ids, num_segments)
    order = torch.argsort(seg, stable=True)
    lengths = _sorted_lengths(seg.index_select(0, order), num_segments)

    def apply(data: torch.Tensor) -> torch.Tensor:
        return _sum_sorted(take_rows(data, order), lengths,
                           num_segments)

    return apply


def sorted_segment_sum(data: torch.Tensor, sorted_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """The float :func:`segment_sum` of rows already in the order of
    ``sorted_ids``, the ids sorted ascending with every id outside ``[0,
    num_segments)`` keyed ``num_segments``: bit for bit ``segment_sum``
    of the same rows in their unsorted order, when that order's stable
    sort gives this one."""
    return _sum_sorted(data, _sorted_lengths(sorted_ids, num_segments),
                       num_segments)


def _sorted_lengths(sorted_seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    # segment starts from the sorted ids (a CUDA bincount would read the
    # largest id back to the host); the dropped entries, sorted last, go
    # in chunks of _DROP_CHUNK so that no one segment holds them all: the
    # CUDA reduction of a 2-D segment runs one thread a column
    m, dev = sorted_seg.shape[0], sorted_seg.device
    bounds = torch.searchsorted(sorted_seg, torch.arange(
        num_segments + 1, device=dev, dtype=sorted_seg.dtype))
    tail = torch.arange(1, m // _DROP_CHUNK + 2, device=dev) * _DROP_CHUNK
    bounds = torch.cat([bounds, torch.clamp(bounds[-1] + tail, max=m)])
    return bounds[1:] - bounds[:-1]


def _sum_sorted(data: torch.Tensor, lengths: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                               unsafe=True)
    return out[:num_segments]


# ----------------------------------------------------------------------------
# Group forms: G graphs of one bucket stacked on a leading axis, each with
# its own ids (what ``jax.vmap`` over a graph axis makes of the functions
# above). Vertex v of graph g is g·n + v in the stacked index space, and
# every id outside [0, n) maps to the one stacked sentinel G·n.
# ----------------------------------------------------------------------------

def group_ids(ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Stacked int64 ids of per-graph ``ids`` ``[G, ...]``: graph g's id
    i in ``[0, num_segments)`` becomes ``g·num_segments + i``, any other
    id the stacked sentinel ``G·num_segments``; same shape as ``ids``."""
    ids = ids.long()
    base = torch.arange(ids.shape[0], device=ids.device).reshape(
        (-1,) + (1,) * (ids.dim() - 1)) * num_segments
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids + base, ids.shape[0] * num_segments)


def take_groups(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``take_fill(x[g], idx[g], fill)`` for every graph g: ``x`` is
    ``[G, n, ...]``, ``idx`` ``[G, ...]`` of each graph's own ids."""
    g, n = x.shape[:2]
    flat = x.reshape((g * n,) + x.shape[2:])
    return take_fill(flat, group_ids(idx, n), fill)


def segment_sum_groups(data: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``segment_sum(data[g], ids[g], num_segments)`` for every graph g of
    ``data`` ``[G, m, ...]`` and ``ids`` ``[G, m]``: ``[G, num_segments,
    ...]``, each float segment summed over the same entries in the same
    order as alone (:func:`segment_sum_groups_plan`)."""
    if not data.is_floating_point():
        g, m = ids.shape
        out = segment_sum(data.reshape((g * m,) + data.shape[2:]),
                          group_ids(ids, num_segments).reshape(-1),
                          g * num_segments)
        return out.reshape((g, num_segments) + data.shape[2:])
    return segment_sum_groups_plan(ids, num_segments)(data)


def segment_sum_groups_plan(ids: torch.Tensor, num_segments: int):
    """The float :func:`segment_sum_groups` over fixed ``ids`` ``[G, m]``,
    its sort done once.

    The entries are sorted stably by (graph, segment), each graph's dropped
    entries last in its own block, so graph g's block is the m positions
    ``[g·m, (g+1)·m)`` and holds the order the graph's own sort gives.
    Every segment is then reduced over the entries it has alone, in that
    order, and its start lies at the same offset modulo m as alone: on the
    card a 1-D segment's reduction (one CUB block a segment) loads a long
    segment in vectors only where its start is 16-byte aligned, so with m
    a multiple of 4 each segment is summed in its own order whatever G."""
    g, m = ids.shape
    dev = ids.device
    seg = _seg_ids(ids, num_segments)
    key = seg + torch.arange(g, device=dev)[:, None] * (num_segments + 1)
    order = torch.argsort(key.reshape(-1), stable=True)
    sorted_seg = seg.reshape(-1).index_select(0, order).view(g, m)
    bounds = torch.searchsorted(sorted_seg, torch.arange(
        num_segments + 1, device=dev).expand(g, -1).contiguous())
    tail = torch.arange(1, m // _DROP_CHUNK + 2, device=dev) * _DROP_CHUNK
    bounds = torch.cat([bounds, torch.clamp(bounds[:, -1:] + tail, max=m)],
                       dim=1)
    lengths = bounds[:, 1:] - bounds[:, :-1]
    width = lengths.shape[1]
    lengths = lengths.reshape(-1)

    def apply(data: torch.Tensor) -> torch.Tensor:
        rows = data.reshape((g * m,) + data.shape[2:])
        out = torch.segment_reduce(take_rows(rows, order), "sum",
                                   lengths=lengths, axis=0, unsafe=True)
        return out.view((g, width) + data.shape[2:])[
            :, :num_segments].contiguous()

    return apply


def segment_max_groups(data, ids, num_segments):
    """:func:`segment_max` of every graph of ``data``/``ids`` ``[G, m]``."""
    g = ids.shape[0]
    out = segment_max(data.reshape((-1,) + data.shape[2:]),
                      group_ids(ids, num_segments).reshape(-1),
                      g * num_segments)
    return out.reshape((g, num_segments) + data.shape[2:])


def _segment_extreme(data, ids, num_segments, reduce, init):
    seg = _seg_ids(ids, num_segments)
    out = torch.full((num_segments + 1,) + data.shape[1:], init,
                     dtype=data.dtype, device=data.device)
    if data.dim() > 1:                  # row-wise: one id a row
        seg = seg.reshape((-1,) + (1,) * (data.dim() - 1)).expand(
            data.shape)
    out = out.scatter_reduce(0, seg, data, reduce, include_self=True)
    return out[:num_segments]


def segment_max(data, ids, num_segments):
    """Per-segment max of ``data`` ([m] or [m, ...], one id a row; an
    entry's gradient is shared evenly by the entries that tie for a max,
    as JAX's). Empty segments give the reference's identity: ``-inf`` for
    floats, the dtype's minimum for integers."""
    init = -float("inf") if data.is_floating_point() else _small(data.dtype)
    return _segment_extreme(data, ids, num_segments, "amax", init)


def segment_min(data, ids, num_segments):
    """Per-segment min, as :func:`segment_max`; empty segments give
    ``inf`` for floats, the dtype's maximum for integers."""
    init = float("inf") if data.is_floating_point() else _big(data.dtype)
    return _segment_extreme(data, ids, num_segments, "amin", init)


def segment_mean(values, seg_ids, num_segments):
    """Per-segment mean of ``values`` ([m] or [m, ...]); empty segments
    give 0."""
    s = segment_sum(values, seg_ids, num_segments)
    n = segment_sum(torch.ones_like(values), seg_ids, num_segments)
    return s / torch.clamp(n, min=1)


def segment_std(values, seg_ids, num_segments):
    """Per-segment population standard deviation (about the segment's
    mean, in two passes, as the reference); empty segments give 0."""
    m = segment_mean(values, seg_ids, num_segments)
    d = values - take_fill(m, seg_ids, 0)
    v = segment_mean(d * d, seg_ids, num_segments)
    return torch.sqrt(torch.maximum(v, v.new_zeros(())))


def segment_softmax(logits: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int, valid=None, plan=None) -> torch.Tensor:
    """Numerically stable softmax within segments (GAT-style edge softmax),
    row-wise over ``logits`` [m] or [m, h] (each column its own softmax,
    as the reference's 1-D call vmapped over heads). Entries whose id is
    outside ``[0, num_segments)`` or whose ``valid`` is False get 0 and
    count in no segment; each segment's maximum (0 where it has no such
    entry) is subtracted, and its denominator clamped at 1e-30.

    The sums and the gathers of the segments' values run on the bag
    kernels (``models.gnn.common.scatter_rows`` / ``gather_rows``) over
    ``plan``, the ``bag_grad_plan`` of ``seg_ids`` for ``num_segments``
    rows (built where needed when None): deterministic, no float atomics.
    The maximum carries no gradient: the softmax does not change with it.
    """
    from repro_torch.models.gnn.common import (edge_max, gather_rows,
                                               scatter_rows)

    lg = logits[:, None] if logits.dim() == 1 else logits
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    if valid is not None:
        ok = ok & valid
    ok = ok[:, None]
    m = edge_max(torch.where(ok, lg, -torch.inf).detach(), seg_ids,
                 num_segments)
    m = torch.where(torch.isfinite(m), m, 0)
    z = torch.exp(torch.where(ok, lg - gather_rows(m, seg_ids), -torch.inf))
    denom = scatter_rows(z, seg_ids, num_segments, plan)
    d = gather_rows(torch.clamp(denom, min=1e-30), seg_ids, plan)
    out = z / torch.where(ok, d, 1.0)
    return out[:, 0] if logits.dim() == 1 else out


def segment_argmax_lex(primary, secondary, payload, seg_ids, num_segments,
                       valid=None):
    """Per-segment payload of the entry maximising (primary, secondary,
    -payload). Empty segments yield (dtype-min, dtype-min, int32-max)."""
    if valid is not None:
        seg_ids = torch.where(valid, seg_ids, num_segments)
    in_range = (seg_ids >= 0) & (seg_ids < num_segments)
    p = torch.where(in_range, primary, _small(primary.dtype))
    best_p = segment_max(p, seg_ids, num_segments)
    on_p = in_range & (p == take_fill(best_p, seg_ids, _big(primary.dtype)))

    s = torch.where(on_p, secondary, _small(secondary.dtype))
    best_s = segment_max(s, seg_ids, num_segments)
    on_s = on_p & (s == take_fill(best_s, seg_ids, _big(secondary.dtype)))

    ids = torch.where(on_s, payload.to(torch.int32), _I32_MAX)
    best_id = segment_min(ids, seg_ids, num_segments)
    return best_p, best_s, best_id


def segment_argmin_lex(primary, payload, seg_ids, num_segments, valid=None):
    """Per-segment payload of the entry minimising (primary, payload): the
    ⊕ of Alg 1. Empty segments yield (dtype-max, int32-max)."""
    if valid is not None:
        seg_ids = torch.where(valid, seg_ids, num_segments)
    in_range = (seg_ids >= 0) & (seg_ids < num_segments)
    p = torch.where(in_range, primary, _big(primary.dtype))
    best_p = segment_min(p, seg_ids, num_segments)
    on_p = in_range & (p == take_fill(best_p, seg_ids, _small(primary.dtype)))

    ids = torch.where(on_p, payload.to(torch.int32), _I32_MAX)
    best_id = segment_min(ids, seg_ids, num_segments)
    return best_p, best_id
