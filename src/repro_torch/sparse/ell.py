"""ELL (ELLPACK) format: the layout of the ``spmv_ell``/``jacobi``/``agg_vote``
kernels (torch port of ``repro.sparse.ell``).

ELL stores a fixed ``width`` of (col, val) slots per row — a dense
``[n_rows, width]`` pair of arrays. Rows shorter than ``width`` pad with
``col = n_cols`` / ``val = 0``; rows longer than ``width`` spill to a COO
remainder (hybrid ELL+COO). Both splits here run on the arrays' own device
and give the reference's layouts bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.sparse.coo import COO, group_sort_key, sort_key
from repro_torch.sparse.segment import group_ids, take_fill


@dataclasses.dataclass(frozen=True)
class ELL:
    col: torch.Tensor  # int32 [n_rows, width], padding = n_cols
    val: torch.Tensor  # float32 [n_rows, width], padding = 0
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.col.shape[0]

    @property
    def width(self) -> int:
        return self.col.shape[1]


def _ranks(r: torch.Tensor) -> torch.Tensor:
    """Rank of each entry within its row, for row-sorted ids: its position
    less the position of its row's first entry (found by a binary search,
    so the host never waits on the device)."""
    r = r.contiguous()
    return (torch.arange(r.shape[0], device=r.device)
            - torch.searchsorted(r, r))


def coo_to_ell(a: COO, width: int | None = None) -> tuple[ELL, COO]:
    """Split a COO into (ELL part, COO remainder).

    Entries beyond ``width`` per row (in (row, col) order) spill to the
    remainder; ``width=None`` takes the maximum row degree.
    """
    ok = a.row < a.n_rows
    row, col, val = a.row[ok], a.col[ok], a.val[ok]
    order = torch.argsort(sort_key(row, col), stable=True)
    row, col, val = row[order], col[order], val[order]
    rank = _ranks(row)
    if width is None:
        w = int(torch.bincount(row.long(), minlength=a.n_rows).max()) \
            if a.n_rows else 0
    else:
        w = int(width)          # width=0 is legal: everything spills
    dev = a.device
    in_ell = rank < w
    ell_col = torch.full((a.n_rows, w), a.n_cols, dtype=torch.int32,
                         device=dev)
    ell_val = torch.zeros((a.n_rows, w), dtype=torch.float32, device=dev)
    ri, ki = row[in_ell].long(), rank[in_ell]
    ell_col[ri, ki] = col[in_ell]
    ell_val[ri, ki] = val[in_ell]

    out = ~in_ell
    n_rem = int(out.sum())
    rem_cap = max(n_rem, 1)
    rrow = torch.full((rem_cap,), a.n_rows, dtype=torch.int32, device=dev)
    rcol = torch.full((rem_cap,), a.n_rows, dtype=torch.int32, device=dev)
    rval = torch.zeros((rem_cap,), dtype=torch.float32, device=dev)
    rrow[:n_rem] = row[out]
    rcol[:n_rem] = col[out]
    rval[:n_rem] = val[out]
    return ELL(ell_col, ell_val, a.n_cols), COO(rrow, rcol, rval, a.n_rows,
                                                 a.n_cols)


def ell_spmv_ref(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """Plain-torch ELL SpMV."""
    return (ell.val * take_fill(x, ell.col, 0)).sum(dim=1)


# ---------------------------------------------------------------------------
# Setup-time layout plan: the twin of the reference's ell_layout_traced.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EllLayout:
    """Hybrid ELL+COO layout plan of one padded edge list.

    ``table`` scatters any per-edge payload (edge weights, quantised
    strengths) into the fixed ``[n_rows, width]`` tile; entries of rank
    >= width per row stay in ``spill_row``/``spill_col`` COO order
    (sentinel ``n_rows``).
    """

    order: torch.Tensor       # int64 [cap]: permutation into (row, col) order
    rr: torch.Tensor          # int64 [cap]: scatter row (sentinel n_rows)
    kk: torch.Tensor          # int64 [cap]: scatter slot in [0, width)
    in_ell: torch.Tensor      # bool [cap], aligned with the sorted order
    col_table: torch.Tensor   # int32 [n_rows, width], sentinel n_rows
    spill_row: torch.Tensor   # int32 [cap], sentinel n_rows
    spill_col: torch.Tensor   # int32 [cap], sentinel n_rows
    n_rows: int
    width: int

    def table(self, values: torch.Tensor, fill=0) -> torch.Tensor:
        """Scatter a per-edge payload (original entry order) into the
        [n_rows, width] ELL tile."""
        v = values[self.order]
        if self.width == 0:
            return v.new_zeros((self.n_rows, 0))
        out = torch.full((self.n_rows + 1, self.width), fill, dtype=v.dtype,
                         device=v.device)
        out[self.rr, self.kk] = torch.where(self.in_ell, v, fill)
        return out[: self.n_rows]

    def spill(self, values: torch.Tensor, fill=0) -> torch.Tensor:
        """The spilled entries of a per-edge payload, aligned with
        ``spill_row``/``spill_col``."""
        v = values[self.order]
        return torch.where(self.spill_row < self.n_rows, v, fill)


def ell_layout_traced(row: torch.Tensor, col: torch.Tensor, n_rows: int,
                      width: int) -> EllLayout:
    """Plan the hybrid split of a padded edge list (sentinel >= ``n_rows``).

    Same arrays as the reference's in-jit planner, padding entries
    included, so a payload scattered through either lands identically.
    Nothing here makes the host wait on the device.
    """
    dev = row.device
    valid = row < n_rows
    row = torch.where(valid, row, n_rows).to(torch.int32)
    col = torch.where(valid, col, n_rows).to(torch.int32)
    order = torch.argsort(sort_key(row, col), stable=True)
    r = row[order]
    c = col[order]
    real = r < n_rows
    rank = _ranks(r)            # padding sorts last; masked out below
    ok = real & (rank < width)
    rr = torch.where(ok, r, n_rows).long()
    kk = torch.where(ok, rank, 0)
    if width:
        col_table = torch.full((n_rows + 1, width), n_rows, dtype=torch.int32,
                               device=dev)
        col_table[rr, kk] = torch.where(ok, c, n_rows)
        col_table = col_table[:n_rows]
    else:
        col_table = torch.zeros((n_rows, 0), dtype=torch.int32, device=dev)
    spilled = real & (rank >= width)
    return EllLayout(order=order, rr=rr, kk=kk, in_ell=ok,
                     col_table=col_table,
                     spill_row=torch.where(spilled, r, n_rows),
                     spill_col=torch.where(spilled, c, n_rows),
                     n_rows=n_rows, width=width)


@dataclasses.dataclass(frozen=True)
class GroupEllLayout:
    """:class:`EllLayout` of each of G padded edge lists of one bucket,
    stacked (the graph-batched vote's tables).

    The tables are ``[G·n_rows, width]``, the same memory as ``[G, n_rows,
    width]``: graph g's rows are ``[g·n_rows, (g+1)·n_rows)`` and hold its
    own column ids (sentinel ``n_rows``), as its own layout's table does.
    The spill arrays are ``[G, cap]`` of each graph's own ids, graph g's
    bit for bit its own layout's; ``order``, ``rr`` (the stacked table
    row, sentinel ``G·n_rows``), ``kk`` and ``in_ell`` are over the
    flattened ``[G·cap]`` entries.
    """

    order: torch.Tensor       # int64 [G·cap]: into (graph, row, col) order
    rr: torch.Tensor          # int64 [G·cap]: stacked scatter row
    kk: torch.Tensor          # int64 [G·cap]: scatter slot in [0, width)
    in_ell: torch.Tensor      # bool [G·cap], aligned with the sorted order
    col_table: torch.Tensor   # int32 [G·n_rows, width], each graph's ids
    spill_row: torch.Tensor   # int32 [G, cap], sentinel n_rows
    spill_col: torch.Tensor   # int32 [G, cap], sentinel n_rows
    n_rows: int               # a graph's rows
    width: int

    @property
    def groups(self) -> int:
        return self.spill_row.shape[0]

    def table(self, values: torch.Tensor, fill=0) -> torch.Tensor:
        """Scatter a per-edge payload ``[G, cap]`` (original entry order)
        into the ``[G·n_rows, width]`` tables."""
        rows = self.groups * self.n_rows
        v = values.reshape(-1)[self.order]
        if self.width == 0:
            return v.new_zeros((rows, 0))
        out = torch.full((rows + 1, self.width), fill, dtype=v.dtype,
                         device=v.device)
        out[self.rr, self.kk] = torch.where(self.in_ell, v, fill)
        return out[:rows]

    def spill(self, values: torch.Tensor, fill=0) -> torch.Tensor:
        """The spilled entries of a per-edge payload ``[G, cap]``, aligned
        with ``spill_row``/``spill_col``."""
        v = values.reshape(-1)[self.order].view(self.spill_row.shape)
        return torch.where(self.spill_row < self.n_rows, v, fill)

    def stacked_col_table(self) -> torch.Tensor:
        """The tables with stacked column ids (graph g's column c as
        ``g·n_rows + c``, padding as the stacked sentinel ``G·n_rows``):
        one ELL table of ``G·n_rows`` rows over a stacked vector, whose
        padding slots read no other graph's entries."""
        g = self.groups
        return group_ids(self.col_table.view(g, self.n_rows, self.width),
                         self.n_rows).to(torch.int32).view(
                             g * self.n_rows, self.width)


def ell_layout_groups(row: torch.Tensor, col: torch.Tensor, n_rows: int,
                      width: int) -> GroupEllLayout:
    """:func:`ell_layout_traced` of each graph of ``[G, cap]`` per-graph
    padded edge lists in one pass: graph g's tables, ranks and spill are
    its own layout's. Nothing here makes the host wait on the device."""
    dev = row.device
    g, cap = row.shape
    valid = row < n_rows
    row = torch.where(valid, row, n_rows).to(torch.int32)
    col = torch.where(valid, col, n_rows).to(torch.int32)
    key = group_sort_key(row, col, n_rows).reshape(-1)
    order = torch.argsort(key, stable=True)
    grow = key.index_select(0, order) >> 32   # stacked row, ascending
    r = row.reshape(-1)[order]
    c = col.reshape(-1)[order]
    real = r < n_rows
    rank = torch.arange(g * cap, device=dev) - torch.searchsorted(grow, grow)
    ok = real & (rank < width)
    graph = torch.arange(g * cap, device=dev) // cap
    rr = torch.where(ok, graph * n_rows + r, g * n_rows)
    kk = torch.where(ok, rank, 0)
    if width:
        col_table = torch.full((g * n_rows + 1, width), n_rows,
                               dtype=torch.int32, device=dev)
        col_table[rr, kk] = torch.where(ok, c, n_rows)
        col_table = col_table[:g * n_rows]
    else:
        col_table = torch.zeros((g * n_rows, 0), dtype=torch.int32,
                                device=dev)
    spilled = real & (rank >= width)
    return GroupEllLayout(order=order, rr=rr, kk=kk, in_ell=ok,
                          col_table=col_table,
                          spill_row=torch.where(spilled, r, n_rows).view(
                              g, cap),
                          spill_col=torch.where(spilled, c, n_rows).view(
                              g, cap),
                          n_rows=n_rows, width=width)
