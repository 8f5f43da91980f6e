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
from repro_torch.sparse.ell import ELL

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


def pow2_bucket(n: int) -> int:
    """Round up to the next power of two: the padded shape of the strength
    and λmax iterations (shape-dependent draws, as in the reference)."""
    return 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)


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
