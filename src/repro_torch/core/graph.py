"""Graph-Laplacian level container (torch port of ``repro.core.graph``).

Every multigrid level is the adjacency of its graph (padded COO, both edge
directions, positive weights) plus the weighted degree vector; the
Laplacian L = diag(deg) − A is never materialised.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sparse import matvec as matvec_ops
from repro_torch.sparse.coo import COO, degrees, row_sums
from repro_torch.sparse.ell import ELL, EllLayout, GroupEllLayout

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GraphLevel:
    """One multigrid level: adjacency + degrees of a weighted graph.

    ``ell``/``ell_rem`` are an optional hybrid ELL+COO twin of ``adj``
    attached at the end of setup (``repro_torch.sparse.matvec``). ``adj``
    stays the source of truth.
    """

    adj: COO
    deg: torch.Tensor               # float32 [n]
    ell: ELL | None = None
    ell_rem: COO | None = None

    @property
    def n(self) -> int:
        return self.adj.n_rows

    def laplacian_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return matvec_ops.laplacian_matvec(self, x)

    def unweighted_degrees(self) -> torch.Tensor:
        return degrees(self.adj)


def graph_from_adjacency(adj: COO) -> GraphLevel:
    return GraphLevel(adj=adj, deg=row_sums(adj))


def attach_setup_twin(level: GraphLevel, lay: EllLayout) -> GraphLevel:
    """``level`` with the hybrid ELL+COO twin of the setup-time layout
    ``lay`` (``setup_ell_sweeps``): the same twin in both setup modes, so
    they stay bitwise equal with the switch on."""
    adj = level.adj
    ell = ELL(lay.col_table, lay.table(adj.val), lay.n_rows)
    rem = COO(lay.spill_row, lay.spill_col, lay.spill(adj.val), lay.n_rows,
              lay.n_rows)
    return dataclasses.replace(level, ell=ell, ell_rem=rem)


@dataclasses.dataclass(frozen=True)
class GroupLevel:
    """G bucket-padded levels of one ``(n_cap, e_cap)`` bucket, stacked on
    a leading graph axis (the batched setup's form of a padded
    :class:`GraphLevel`): each graph's edge list with its own ids, sentinel
    ``n_cap`` and padding last, and its degrees. ``ell``/``ell_rem`` are an
    optional stacked twin (``setup_ell_sweeps``,
    :func:`attach_setup_twin_groups`): one ``[G·n_cap, width]`` ELL table
    with stacked column ids, and each graph's spill ``(row, col, val)``
    ``[G, cap]``."""

    row: torch.Tensor               # int32 [G, e_cap]
    col: torch.Tensor               # int32 [G, e_cap]
    val: torch.Tensor               # float32 [G, e_cap]
    deg: torch.Tensor               # float32 [G, n_cap]
    ell: ELL | None = None
    ell_rem: tuple | None = None

    @property
    def n(self) -> int:
        return self.deg.shape[1]

    @property
    def groups(self) -> int:
        return self.deg.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return self.row < self.n

    def laplacian_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return matvec_ops.laplacian_matvec_groups(self, x)


def attach_setup_twin_groups(level: GroupLevel,
                             lay: GroupEllLayout) -> GroupLevel:
    """:func:`attach_setup_twin` of every graph of a group at once."""
    ell = ELL(lay.stacked_col_table(), lay.table(level.val),
              lay.groups * lay.n_rows)
    rem = (lay.spill_row, lay.spill_col, lay.spill(level.val))
    return dataclasses.replace(level, ell=ell, ell_rem=rem)


def pow2_bucket(n: int, floor: int = 0) -> int:
    """Round up to the next power of two, and to at least ``floor``.

    The one bucket rule of the hierarchy's capacities, the super-step
    setup's padded shapes (``repro_torch.core.setup_step``) and the
    strength and λmax iterations' padded state: the eager and super-step
    setups compute over identical shapes only while these agree.
    """
    b = 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)
    return max(b, floor, 1)


def count_tensor(n, device) -> torch.Tensor:
    """A vertex count as a 0-d int32 tensor on ``device`` (a tensor count
    is returned as it is): the divisor of the strength and λmax means.
    The super-step setup knows its counts only on the device; the eager
    setup divides by the same kind of operand, since CUDA divides by a
    host scalar through its reciprocal, which may round differently."""
    if isinstance(n, torch.Tensor):
        return n
    return torch.full((), n, dtype=torch.int32, device=device)


def laplacian_dense(level: GraphLevel) -> torch.Tensor:
    """Dense L (tests / coarsest solve only)."""
    return torch.diag(level.deg) - level.adj.to_dense()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche hash of vertex ids, as uint32 values held
    in int64 (torch has no ``>>`` on uint32)."""
    x = x.long() & _M32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)
