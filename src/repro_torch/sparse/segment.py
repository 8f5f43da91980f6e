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


def take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``x[idx]`` along dim 0, with ``fill`` where ``idx`` is out of range."""
    n = x.shape[0]
    ok = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.full(idx.shape + x.shape[1:], fill, dtype=x.dtype,
                          device=x.device)
    flat = idx.reshape(-1).long().clamp(0, n - 1)
    g = x.index_select(0, flat).reshape(idx.shape + x.shape[1:])
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
    m, dev = seg.shape[0], seg.device
    # segment starts from the sorted ids (a CUDA bincount would read the
    # largest id back to the host); the dropped entries, sorted last, go
    # in chunks of _DROP_CHUNK so that no one segment holds them all: the
    # CUDA reduction of a 2-D segment runs one thread a column
    bounds = torch.searchsorted(seg.index_select(0, order),
                                torch.arange(num_segments + 1, device=dev))
    tail = torch.arange(1, m // _DROP_CHUNK + 2, device=dev) * _DROP_CHUNK
    bounds = torch.cat([bounds, torch.clamp(bounds[-1] + tail, max=m)])
    lengths = bounds[1:] - bounds[:-1]

    def apply(data: torch.Tensor) -> torch.Tensor:
        out = torch.segment_reduce(data.index_select(0, order), "sum",
                                   lengths=lengths, axis=0, unsafe=True)
        return out[:num_segments]

    return apply


def _segment_extreme(data, ids, num_segments, reduce, init):
    seg = _seg_ids(ids, num_segments)
    out = torch.full((num_segments + 1,), init, dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, seg, data, reduce, include_self=True)
    return out[:num_segments]


def segment_max(data, ids, num_segments):
    """Per-segment max; empty segments give the dtype's minimum."""
    return _segment_extreme(data, ids, num_segments, "amax",
                            _small(data.dtype))


def segment_min(data, ids, num_segments):
    """Per-segment min; empty segments give the dtype's maximum."""
    return _segment_extreme(data, ids, num_segments, "amin",
                            _big(data.dtype))


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
