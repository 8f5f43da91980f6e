"""Fixed-capacity padded COO sparse matrices (torch port of ``repro.sparse.coo``).

Every COO carries a ``capacity`` of entry slots. Padding slots use the
sentinel ``row = col = n_rows`` with ``val = 0``: segment reductions drop
them and gathers of them read the fill value (``repro_torch.sparse.segment``).
Indices are int32 tensors and values float32, on whatever device the
arrays were built on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.segment import (per_row, segment_max,
                                        segment_max_groups, segment_sum,
                                        segment_sum_groups, take_fill)


@dataclasses.dataclass(frozen=True)
class COO:
    """Padded COO matrix of logical shape ``(n_rows, n_cols)``.

    ``row``/``col``/``val`` all have shape ``(capacity,)``. Entries with
    ``row >= n_rows`` are padding. Duplicate (row, col) pairs add.
    """

    row: torch.Tensor  # int32 [capacity]
    col: torch.Tensor  # int32 [capacity]
    val: torch.Tensor  # float32 [capacity]
    n_rows: int
    n_cols: int

    @property
    def capacity(self) -> int:
        return self.row.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row.device

    @property
    def valid(self) -> torch.Tensor:
        return self.row < self.n_rows

    @property
    def nnz(self) -> int:
        """Number of non-padding entries (a host sync)."""
        return int(self.valid.sum())

    def with_capacity(self, capacity: int) -> "COO":
        """Shrink to ``capacity`` slots; sound only when the dropped
        trailing slots are padding (a coalesce output's are)."""
        return COO(self.row[:capacity], self.col[:capacity],
                   self.val[:capacity], self.n_rows, self.n_cols)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.n_rows + 1, self.n_cols + 1),
                          dtype=self.val.dtype, device=self.device)
        r = self.row.long().clamp(max=self.n_rows)
        c = self.col.long().clamp(max=self.n_cols)
        out.index_put_((r, c), torch.where(self.valid, self.val, 0),
                       accumulate=True)
        return out[: self.n_rows, : self.n_cols]


def coo_from_dense(a, capacity: int | None = None, device=None) -> COO:
    """The nonzeros of a dense host matrix in row-major order, padded to
    ``capacity`` (default: its nonzero count, at least 1), on ``device``
    (default: the CUDA card); float32 values."""
    a = np.asarray(a)
    r, c = np.nonzero(a)
    return coo_from_arrays(r, c, a[r, c], a.shape[0], a.shape[1],
                           capacity=capacity, device=device)


def coo_from_arrays(row, col, val, n_rows: int, n_cols: int,
                    capacity: int | None = None, device=None) -> COO:
    """Build a COO from host arrays, padding to ``capacity``, on ``device``
    (default: the CUDA card, see :func:`repro_torch.device.resolve_device`)."""
    row = np.asarray(row, np.int32)
    col = np.asarray(col, np.int32)
    val = np.asarray(val, np.float32)
    nnz = row.shape[0]
    cap = capacity if capacity is not None else max(nnz, 1)
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    r = np.full((cap,), n_rows, np.int32)
    c = np.full((cap,), n_rows, np.int32)
    v = np.zeros((cap,), np.float32)
    r[:nnz] = row
    c[:nnz] = col
    v[:nnz] = val
    dev = resolve_device(device)
    return COO(torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev),
               torch.from_numpy(v).to(dev), n_rows, n_cols)


# ----------------------------------------------------------------------------
# Core ops (sum semiring): the oracles of the ELL kernels and the spill path
# of the hybrid SpMV. Every float reduction here is a deterministic
# sorted-segment sum.
# ----------------------------------------------------------------------------

def spmv(a: COO, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x. x: [n_cols] -> y: [n_rows]; a block [n_cols, k] is
    :func:`spmm` (one segment sum for all k columns)."""
    if x.dim() == 2:
        return spmm(a, x)
    xg = take_fill(x, a.col, 0)
    prod = torch.where(a.valid, a.val * xg, 0)
    return segment_sum(prod, a.row, a.n_rows)


def spmv_t(a: COO, x: torch.Tensor) -> torch.Tensor:
    """y = Aᵀ @ x without materialising the transpose; x: [n_rows] or a
    block [n_rows, k]."""
    xg = take_fill(x, a.row, 0)
    prod = torch.where(per_row(a.valid, xg), per_row(a.val, xg) * xg, 0)
    col = torch.where(a.valid, a.col, a.n_cols)
    return segment_sum(prod, col, a.n_cols)


def spmm(a: COO, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X. X: [n_cols, d] -> Y: [n_rows, d]."""
    xg = take_fill(x, a.col, 0)
    prod = torch.where(a.valid[:, None], a.val[:, None] * xg, 0)
    return segment_sum(prod, a.row, a.n_rows)


def row_sums(a: COO) -> torch.Tensor:
    return segment_sum(torch.where(a.valid, a.val, 0), a.row, a.n_rows)


def extract_diag(a: COO) -> torch.Tensor:
    """The diagonal (duplicates summed), [n_rows]."""
    on_diag = a.valid & (a.row == a.col)
    return segment_sum(torch.where(on_diag, a.val, 0), a.row, a.n_rows)


def degrees(a: COO) -> torch.Tensor:
    """Unweighted row degree (number of valid entries per row), int32."""
    return segment_sum(a.valid.to(torch.int32), a.row, a.n_rows)


def sort_key(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """int64 key whose order is the (row, col) lexicographic order of
    non-negative int32 ids: torch's stand-in for ``jnp.lexsort((col, row))``
    under a stable sort."""
    return (row.long() << 32) | col.long()


def coalesce_arrays(row, col, val, n_rows, capacity: int, sentinel=None):
    """Sum duplicate (row, col) entries and drop padding.

    Returns ``(row, col, val, nnz)``: arrays of length ``capacity``, sorted
    by (row, col) with padding (``sentinel``, default ``n_rows``) last,
    and the count of real entries as a 0-d tensor. ``n_rows`` may be an
    int or a 0-d tensor on the arrays' device (the bucket-padded setup
    steps), so nothing here makes the host wait on the device.
    Duplicates are summed in their input order, so the result is
    deterministic and matches the reference's ``coalesce_arrays``.
    """
    if sentinel is None:
        sentinel = n_rows
    valid = row < n_rows
    row = torch.where(valid, row, sentinel).to(torch.int32)
    col = torch.where(valid, col, sentinel).to(torch.int32)
    order = torch.argsort(sort_key(row, col), stable=True)
    r = row[order]
    c = col[order]
    v = torch.where(valid, val, 0)[order]
    first = torch.ones_like(r, dtype=torch.bool)
    if r.shape[0] > 1:
        first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    seg = torch.cumsum(first.to(torch.int32), 0) - 1
    summed = segment_sum(v, seg, capacity)
    rep_row = segment_max(r, seg, capacity)
    rep_col = segment_max(c, seg, capacity)
    is_pad = (rep_row < 0) | (rep_row >= n_rows)
    out_row = torch.where(is_pad, sentinel, rep_row).to(torch.int32)
    out_col = torch.where(is_pad, sentinel, rep_col).to(torch.int32)
    out_val = torch.where(is_pad, 0.0, summed)
    return out_row, out_col, out_val, (~is_pad).sum()


def group_sort_key(row: torch.Tensor, col: torch.Tensor,
                   sentinel: int) -> torch.Tensor:
    """int64 key of ``[G, m]`` per-graph ids in ``[0, sentinel]`` whose
    order is (graph, row, col): :func:`sort_key` of the stacked row
    ``g·(sentinel + 1) + row``, so each graph's entries stay in one block
    in their own (row, col) order, its padding last in the block."""
    base = torch.arange(row.shape[0], device=row.device)[:, None] \
        * (sentinel + 1)
    return sort_key(row.long() + base, col)


def coalesce_arrays_groups(row, col, val, n_rows, capacity: int,
                           sentinel: int):
    """:func:`coalesce_arrays` of each graph of a group: ``row``, ``col``,
    ``val`` ``[G, m]`` with each graph's own ids, ``n_rows`` an int or a
    ``[G]`` tensor. Returns ``[G, capacity]`` arrays and the counts
    ``[G]``; graph g's are bit for bit its own coalesce's (the same stable
    order, the same segment sums)."""
    g, m = row.shape
    if isinstance(n_rows, torch.Tensor):
        n_rows = n_rows[:, None]
    valid = row < n_rows
    row = torch.where(valid, row, sentinel).to(torch.int32)
    col = torch.where(valid, col, sentinel).to(torch.int32)
    order = torch.argsort(group_sort_key(row, col, sentinel).reshape(-1),
                          stable=True)
    r = row.reshape(-1)[order].view(g, m)
    c = col.reshape(-1)[order].view(g, m)
    v = torch.where(valid, val, 0).reshape(-1)[order].view(g, m)
    first = torch.ones_like(r, dtype=torch.bool)
    if m > 1:
        first[:, 1:] = (r[:, 1:] != r[:, :-1]) | (c[:, 1:] != c[:, :-1])
    seg = torch.cumsum(first.to(torch.int32), 1) - 1
    summed = segment_sum_groups(v, seg, capacity)
    rep_row = segment_max_groups(r, seg, capacity)
    rep_col = segment_max_groups(c, seg, capacity)
    is_pad = (rep_row < 0) | (rep_row >= n_rows)
    out_row = torch.where(is_pad, sentinel, rep_row).to(torch.int32)
    out_col = torch.where(is_pad, sentinel, rep_col).to(torch.int32)
    out_val = torch.where(is_pad, 0.0, summed)
    return out_row, out_col, out_val, (~is_pad).sum(1)


def coalesce(row, col, val, n_rows: int, n_cols: int, capacity: int) -> COO:
    """:func:`coalesce_arrays` packaged as a :class:`COO`."""
    out_row, out_col, out_val, _ = coalesce_arrays(row, col, val, n_rows,
                                                   capacity)
    return COO(out_row, out_col, out_val, n_rows, n_cols)
