"""Unsmoothed-aggregation Galerkin coarsening (paper §2, §2.4; torch port of
``repro.core.coarsen``).

With piecewise-constant P the Galerkin operator PᵀLP is edge contraction:
relabel both endpoints of every edge by aggregate id, sum duplicates, and
drop the edges that became self-loops — one coalesce.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import GraphLevel, graph_from_adjacency
from repro_torch.sparse.coo import (COO, coalesce_arrays,
                                    coalesce_arrays_groups)
from repro_torch.sparse.segment import segment_sum, take_fill, take_groups


@dataclasses.dataclass(frozen=True)
class AggregationLevel:
    """UA level: restriction = segment-sum over aggregates, prolongation =
    gather."""

    fine: GraphLevel
    coarse: GraphLevel
    coarse_id: torch.Tensor   # int32 [n_fine] -> [0, n_coarse)

    @property
    def n_fine(self) -> int:
        return self.fine.n

    @property
    def n_coarse(self) -> int:
        return self.coarse.n

    # a vector or the rows of an [n, k] block: the segment sum and the
    # gather act on dim 0
    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        return segment_sum(r, self.coarse_id, self.n_coarse)

    def prolong(self, x_c: torch.Tensor) -> torch.Tensor:
        return take_fill(x_c, self.coarse_id, 0)


def contract_arrays(adj: COO, coarse_id: torch.Tensor, n_coarse,
                    sentinel=None, out_capacity: int | None = None):
    """Relabel both endpoints of every edge by aggregate id and coalesce,
    dropping self-loops. ``n_coarse`` may be an int or a 0-d tensor (the
    bucket-padded setup); ``sentinel`` is the padding id of the output
    (default ``n_coarse``). Returns ``(row, col, val, nnz)``: arrays of
    length ``out_capacity`` (default ``adj.capacity``), padding last, and
    ``nnz`` as a 0-d tensor."""
    n = adj.n_rows
    if sentinel is None:
        sentinel = n_coarse
    cr = take_fill(coarse_id, adj.row.clamp(max=n - 1), 0)
    cc = take_fill(coarse_id, adj.col.clamp(max=n - 1), 0)
    keep = adj.valid & (cr != cc)
    row = torch.where(keep, cr, sentinel)
    col = torch.where(keep, cc, sentinel)
    val = torch.where(keep, adj.val, 0)
    return coalesce_arrays(row, col, val, n_coarse,
                           out_capacity or adj.capacity, sentinel=sentinel)


def contract_arrays_groups(row, col, val, n: int, coarse_id: torch.Tensor,
                           n_coarse: torch.Tensor, sentinel: int,
                           out_capacity: int):
    """:func:`contract_arrays` of every graph of a group: ``row``, ``col``,
    ``val`` ``[G, m]`` (each graph's own ids, padding ``>= n``),
    ``coarse_id`` ``[G, n]``, ``n_coarse`` ``[G]``. Returns ``[G,
    out_capacity]`` arrays and the ``[G]`` counts."""
    cr = take_groups(coarse_id, row.clamp(max=n - 1), 0)
    cc = take_groups(coarse_id, col.clamp(max=n - 1), 0)
    keep = (row < n) & (cr != cc)
    row = torch.where(keep, cr, sentinel)
    col = torch.where(keep, cc, sentinel)
    val = torch.where(keep, val, 0)
    return coalesce_arrays_groups(row, col, val, n_coarse, out_capacity,
                                  sentinel=sentinel)


def contract(level: GraphLevel, coarse_id: torch.Tensor, n_coarse: int,
             coarse_capacity: int | None = None) -> AggregationLevel:
    """Build PᵀLP by edge contraction."""
    row, col, val, _ = contract_arrays(
        level.adj, coarse_id, n_coarse,
        out_capacity=coarse_capacity or level.adj.capacity)
    coarse = graph_from_adjacency(COO(row, col, val, n_coarse, n_coarse))
    return AggregationLevel(fine=level, coarse=coarse,
                            coarse_id=coarse_id.to(torch.int32))
