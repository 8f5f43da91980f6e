"""Hybrid ELL+COO matvec layer — the solve-phase hot path (torch port of
``repro.sparse.matvec``).

Backends, chosen at setup (``SetupConfig.matvec_backend``):

* ``"coo"`` — the gather + deterministic segment-sum path
  (``repro_torch.sparse.coo.spmv``); the default, as in the reference.
* ``"ell"`` — every level gets a hybrid ELL+COO twin: a fixed-width
  ``[rows, width]`` table run by the ``spmv_ell``/``jacobi`` kernels, plus a
  COO remainder for overlong rows.
* ``"auto"`` — a level gets a twin only where the fixed width pays.

A twin runs through the kernel wrappers, which launch the CUDA kernel on a
CUDA tensor and run the plain version only on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.coo import COO, spmv
from repro_torch.sparse.ell import ELL, coo_to_ell
from repro_torch.sparse.segment import (per_row, segment_sum_groups,
                                        take_groups)

MATVEC_BACKENDS = ("coo", "ell", "auto")

MIN_ELL_ROWS = 256
MAX_PAD_FACTOR = 3.0


def validate_backend(backend: str) -> str:
    if backend not in MATVEC_BACKENDS:
        raise ValueError(
            f"matvec_backend must be one of {MATVEC_BACKENDS}, "
            f"got {backend!r}")
    return backend


def select_ell_width(counts, backend: str, *, percentile: float = 95.0,
                     cap: int = 64, min_rows: int = MIN_ELL_ROWS,
                     max_pad_factor: float = MAX_PAD_FACTOR) -> int | None:
    """Choose the hybrid split width for one level (or refuse with None):
    a capped percentile of the row degrees; ``"auto"`` also refuses small
    levels and widths that would be mostly padding."""
    validate_backend(backend)
    if backend == "coo":
        return None
    counts = np.asarray(counts)
    nnz = int(counts.sum()) if counts.size else 0
    max_deg = int(counts.max()) if counts.size else 0
    if nnz == 0 or max_deg == 0:
        return None
    width = int(np.ceil(np.percentile(counts, percentile)))
    width = max(1, min(width, cap, max_deg))
    if backend == "ell":
        return width
    if counts.size < min_rows:
        return None
    if counts.size * width > max_pad_factor * nnz:
        return None
    return width


def split_hybrid(adj: COO, width: int) -> tuple[ELL, COO | None, dict]:
    """Split ``adj`` into (ELL part, COO remainder-or-None, stats). The
    remainder is None when nothing spills."""
    ell, rem = coo_to_ell(adj, width=width)
    spill_nnz = rem.nnz
    nnz = adj.nnz
    stats = dict(width=width, spill_nnz=spill_nnz,
                 spill_fraction=spill_nnz / max(nnz, 1),
                 pad_fraction=1.0 - (nnz - spill_nnz) /
                 max(adj.n_rows * max(width, 1), 1))
    return ell, (rem if spill_nnz else None), stats


def build_hybrid(adj: COO, backend: str, *, percentile: float = 95.0,
                 cap: int = 64) -> tuple[ELL, COO | None] | None:
    """Plan one level's ELL twin ``(ell, remainder)``, or None when the
    level stays on the COO path."""
    validate_backend(backend)
    if backend == "coo":
        return None
    row = adj.row.long()
    counts = torch.bincount(row[row < adj.n_rows], minlength=adj.n_rows)
    width = select_ell_width(counts.cpu().numpy(), backend,
                             percentile=percentile, cap=cap)
    if width is None:
        return None
    ell, rem, _ = split_hybrid(adj, width)
    return ell, rem


# ----------------------------------------------------------------------------
# Solve-phase operators: the only SpMV entry points of the smoother,
# residual, PCG and cycle loop.
# ----------------------------------------------------------------------------

def hybrid_spmv(ell: ELL, rem: COO | None, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through the hybrid ELL+COO split, for a vector ``x`` or a
    row-major block ``[n, k]`` (one k-column kernel launch and one spill
    segment sum for all k columns). ``width == 0`` degrades to
    remainder-only."""
    from repro_torch.kernels.spmv_ell import spmv_ell

    if ell.width == 0:
        y = torch.zeros((ell.n_rows,) + x.shape[1:], dtype=x.dtype,
                        device=x.device)
    else:
        y = spmv_ell(ell.col, ell.val, x)
    if rem is not None:
        y = y + spmv(rem, x)
    return y


def level_spmv(level, x: torch.Tensor) -> torch.Tensor:
    """A @ x for a level, dispatching on its attached layout; ``x`` a
    vector or a block ``[n, k]``."""
    ell = getattr(level, "ell", None)
    if ell is None:
        return spmv(level.adj, x)
    return hybrid_spmv(ell, level.ell_rem, x)


def laplacian_matvec(level, x: torch.Tensor) -> torch.Tensor:
    """L @ x = deg * x - A @ x through the selected execution format, for a
    vector or each column of a block."""
    return per_row(level.deg, x) * x - level_spmv(level, x)


def level_spmm(level, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for [n, d] blocks (the strength sweeps): the k-column
    ``spmv_ell`` kernel where a level carries an ELL twin (the reference
    vmaps its kernel over the columns), else the COO ``spmm``."""
    return level_spmv(level, x)


# ----------------------------------------------------------------------------
# Group forms (the batched setup): G graphs' levels stacked on a leading
# axis (``core.graph.GroupLevel``); ``x`` is ``[G, n]`` (a vector a graph)
# or ``[G, n, k]`` (a block a graph), graph g's result bit for bit its
# level's alone.
# ----------------------------------------------------------------------------

def spmv_groups(row, col, val, n: int, x: torch.Tensor) -> torch.Tensor:
    """``spmv``/``spmm`` of each graph's COO ``(row, col, val)`` ``[G, m]``
    (its own ids, padding ``>= n``) on its ``x[g]``."""
    xg = take_groups(x, col, 0)
    valid = row < n
    if x.dim() == 3:
        prod = torch.where(valid[..., None], val[..., None] * xg, 0)
    else:
        prod = torch.where(valid, val * xg, 0)
    return segment_sum_groups(prod, row, n)


def level_spmv_groups(level, x: torch.Tensor) -> torch.Tensor:
    """:func:`level_spmv` of every graph of a ``GroupLevel``: its stacked
    ELL twin through one kernel launch for the group (the rows of one
    graph gather only its own entries) and the spill a graph, or the COO
    path."""
    from repro_torch.kernels.spmv_ell import spmv_ell

    n = level.n
    if level.ell is None:
        return spmv_groups(level.row, level.col, level.val, n, x)
    ell = level.ell
    flat = x.reshape((ell.n_rows,) + x.shape[2:])
    if ell.width == 0:
        y = torch.zeros_like(flat)
    else:
        y = spmv_ell(ell.col, ell.val, flat)
    y = y.view(x.shape)
    if level.ell_rem is not None:
        y = y + spmv_groups(*level.ell_rem, n, x)
    return y


def laplacian_matvec_groups(level, x: torch.Tensor) -> torch.Tensor:
    """:func:`laplacian_matvec` of every graph of a ``GroupLevel``."""
    deg = level.deg if x.dim() == 2 else level.deg[..., None]
    return deg * x - level_spmv_groups(level, x)
