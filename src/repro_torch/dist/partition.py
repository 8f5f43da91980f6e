"""2D block partition of a graph edge list (paper §2.1–§2.2; torch port of
``repro.dist.partition``).

The paper distributes the Laplacian over a √P × √P processor grid: vertex
ids are split into contiguous blocks, and edge (u, v) lands on the
processor owning row-block(u) × column-block(v). Every block is padded to
one common edge capacity, so load balance is also the *fill fraction*:
the share of padded slots holding real edges. Balance comes from the
paper's §2.2 trick: relabel vertices by a random permutation before
blocking, which spreads every hub's edges over the grid.

An optional ``pods`` axis splits each block's edge *slots* round-robin
across a third (outer) mesh axis: the same 2D block structure, with each
block's SpMV partial summed across pods by the same all-reduce that sums
across column blocks.

Everything here is host numpy and gives the reference's arrays element
for element. Every rank of a mesh computes the same partition and keeps
its own block (:func:`rank_block`, :func:`rank_ell_block`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.matvec import select_ell_width


def row_ranks_sorted(row: np.ndarray) -> np.ndarray:
    """Rank of each entry within its row, for a row-sorted entry list
    (the ELL slot index; the reference's ``repro.sparse.ell``
    helper)."""
    if not len(row):
        return np.zeros((0,), np.int64)
    starts = np.concatenate([[0], np.flatnonzero(row[1:] != row[:-1]) + 1])
    sizes = np.diff(np.concatenate([starts, [len(row)]]))
    return np.arange(len(row)) - np.repeat(starts, sizes)


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """Padded block-local COO layout of one graph over a (pods, pr, pc) grid.

    ``row_local``/``col_local``/``val`` have shape ``[pods, pr, pc, cap]``.
    Block (p, i, j) holds edges whose (permuted) endpoints fall in row
    block i and column block j; slot padding uses the sentinels
    ``row_local == nb`` / ``col_local == nb_col`` with ``val == 0``.
    """

    row_local: np.ndarray     # int32 [pods, pr, pc, cap]; sentinel = nb
    col_local: np.ndarray     # int32 [pods, pr, pc, cap]; sentinel = nb_col
    val: np.ndarray           # float32 [pods, pr, pc, cap]; 0 on padding
    n: int                    # number of real vertices
    n_pad: int                # padded vertex count (divisible by pr and pc)
    pr: int                   # row blocks
    pc: int                   # column blocks
    pods: int                 # outer edge-splitting axis
    nb: int                   # row block size      = n_pad // pr
    nb_col: int               # column block size   = n_pad // pc
    nnz: int                  # total real edges (both directions)
    block_nnz: np.ndarray     # int64 [pods, pr, pc] real edges per block
    perm: np.ndarray | None   # old vertex id -> new id (None: natural order)

    @property
    def capacity(self) -> int:
        return int(self.row_local.shape[-1])

    @property
    def n_blocks(self) -> int:
        return self.pods * self.pr * self.pc

    @property
    def fill_fraction(self) -> float:
        """Real edges / padded slots — the §2.2 balance metric."""
        return self.nnz / float(max(self.n_blocks * self.capacity, 1))


def partition_edges_2d(n: int, rows, cols, vals, pr: int, pc: int,
                       pods: int = 1, random_ordering: bool = True,
                       seed: int = 0) -> Partition2D:
    """Partition an edge list (both directions present) onto a 2D grid.

    ``random_ordering=True`` applies the paper's §2.2 random vertex
    relabeling before blocking; :func:`pad_vector`/:func:`unpad_vector`
    translate between user vectors (original ids) and the partitioned
    layout.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError("rows/cols/vals must have identical shapes")
    if pr < 1 or pc < 1 or pods < 1:
        raise ValueError("pr, pc and pods must be positive")

    perm = None
    if random_ordering:
        perm = np.random.default_rng(seed).permutation(n)
        rq, cq = perm[rows], perm[cols]
    else:
        rq, cq = rows, cols

    blk = -(-n // (pr * pc))            # ceil: n_pad divisible by pr AND pc
    n_pad = blk * pr * pc
    nb = n_pad // pr
    nb_col = n_pad // pc

    bi = rq // nb
    bj = cq // nb_col
    flat = bi * pc + bj
    counts = np.bincount(flat, minlength=pr * pc)
    cap = max(1, int(-(-counts.max() // pods))) if len(rows) else 1

    # stable block-major order; the position within a block decides the
    # pod slice (round-robin) and the slot inside that slice
    order = np.argsort(flat, kind="stable")
    starts = np.zeros(pr * pc, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    pos = np.arange(len(rows), dtype=np.int64) - starts[flat[order]]
    pod = pos % pods
    slot = pos // pods

    row_local = np.full((pods, pr, pc, cap), nb, np.int32)
    col_local = np.full((pods, pr, pc, cap), nb_col, np.int32)
    val = np.zeros((pods, pr, pc, cap), np.float32)
    block = (pod * pr + bi[order]) * pc + bj[order]
    at = block * cap + slot             # flat slot index of each edge
    row_local.reshape(-1)[at] = (rq[order] % nb).astype(np.int32)
    col_local.reshape(-1)[at] = (cq[order] % nb_col).astype(np.int32)
    val.reshape(-1)[at] = vals[order]

    block_nnz = np.bincount(block, minlength=pods * pr * pc
                            ).astype(np.int64).reshape(pods, pr, pc)

    return Partition2D(row_local=row_local, col_local=col_local, val=val,
                       n=n, n_pad=n_pad, pr=pr, pc=pc, pods=pods,
                       nb=nb, nb_col=nb_col, nnz=int(len(rows)),
                       block_nnz=block_nnz, perm=perm)


def pad_vector(part: Partition2D, x) -> np.ndarray:
    """Vertex vector (original ids, length n) -> partitioned layout [n_pad]."""
    x = np.asarray(x)
    out = np.zeros((part.n_pad,) + x.shape[1:], x.dtype)
    if part.perm is None:
        out[: part.n] = x
    else:
        out[part.perm] = x
    return out


def unpad_vector(part: Partition2D, y) -> np.ndarray:
    """Inverse of :func:`pad_vector`: [n_pad] layout -> length-n vector."""
    y = np.asarray(y)
    if part.perm is None:
        return y[: part.n].copy()
    return y[part.perm]


def balance_report(part: Partition2D) -> dict:
    """Per-device-block balance summary (the paper's Table 1 quantities)."""
    bn = part.block_nnz.reshape(-1).astype(np.float64)
    mean = bn.mean() if bn.size else 0.0
    return dict(
        imbalance=float(bn.max() / max(mean, 1e-12)) if bn.size else 0.0,
        fill_fraction=float(part.fill_fraction),
        max_nnz=int(bn.max()) if bn.size else 0,
        min_nnz=int(bn.min()) if bn.size else 0,
        mean_nnz=float(mean),
        n_blocks=part.n_blocks,
        capacity=part.capacity,
        nnz=part.nnz,
    )


# ---------------------------------------------------------------------------
# Per-block hybrid ELL+COO layout (the dist-local hot-loop format).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EllBlocks:
    """Hybrid ELL+COO twin of a ``Partition2D``: one bounded-width ELL
    block per device plus a per-block COO spill for overlong rows.

    Column/row ids are *global* (padded-vertex ids in ``[0, n_pad)``) with
    sentinel ``n_pad``: each rank gathers straight from the replicated x
    vector, and only the ELL row offset (``i * nb``) depends on the rank.
    All blocks share one ``width`` and one ``spill_cap``.
    """

    col: np.ndarray        # int32 [pods, pr, pc, nb, width]; sentinel n_pad
    val: np.ndarray        # float32 [pods, pr, pc, nb, width]; 0 on padding
    spill_row: np.ndarray  # int32 [pods, pr, pc, spill_cap]; sentinel n_pad
    spill_col: np.ndarray  # int32 [pods, pr, pc, spill_cap]; sentinel n_pad
    spill_val: np.ndarray  # float32 [pods, pr, pc, spill_cap]; 0 on padding
    width: int
    spill_nnz: int         # total real spill edges across all blocks

    @property
    def spill_cap(self) -> int:
        return int(self.spill_row.shape[-1])


def block_row_counts(part: Partition2D) -> np.ndarray:
    """int64 [pods, pr, pc, nb]: real entries per (block, local row)."""
    pods, pr, pc, nb = part.pods, part.pr, part.pc, part.nb
    valid = part.row_local < nb
    blocks = np.arange(pods * pr * pc).reshape(pods, pr, pc, 1)
    ids = (blocks * nb + part.row_local)[valid]
    return np.bincount(ids, minlength=pods * pr * pc * nb
                       ).astype(np.int64).reshape(pods, pr, pc, nb)


def ell_width_for(part: Partition2D, counts: np.ndarray | None = None,
                  width: int | None = None, percentile: float = 95.0,
                  cap: int = 64, backend: str = "ell") -> int | None:
    """The blocks' common ELL width, the per-level layout selection of
    ``repro_torch.sparse.matvec.select_ell_width`` over every block row's
    occupancy; None where ``"auto"`` keeps the level on COO execution."""
    if width is not None:
        return int(width)
    if counts is None:
        counts = block_row_counts(part)
    selected = select_ell_width(counts.reshape(-1), backend,
                                percentile=percentile, cap=cap)
    if selected is None and backend != "ell":
        return None
    return selected or 1


def _block_split(part: Partition2D, p: int, i: int, j: int, width: int):
    """One block's ELL table and spill, with global ids."""
    nb, nb_col, n_pad = part.nb, part.nb_col, part.n_pad
    ok = part.row_local[p, i, j] < nb
    r = part.row_local[p, i, j][ok].astype(np.int64)
    c = part.col_local[p, i, j][ok].astype(np.int64)
    v = part.val[p, i, j][ok]
    # (row, col) order, as the reference's lexsort gives it: a stable sort
    # of one int64 key, skipped where the entries are in that order
    # already (a coalesced level's are)
    key = (r << 32) | c
    if len(key) > 1 and bool((key[1:] < key[:-1]).any()):
        order = np.argsort(key, kind="stable")
        r, c, v = r[order], c[order], v[order]
    rank = row_ranks_sorted(r)
    in_ell = rank < width
    col = np.full((nb, width), n_pad, np.int32)
    val = np.zeros((nb, width), np.float32)
    col[r[in_ell], rank[in_ell]] = (j * nb_col + c[in_ell]).astype(np.int32)
    val[r[in_ell], rank[in_ell]] = v[in_ell]
    spill = ((i * nb + r[~in_ell]).astype(np.int32),
             (j * nb_col + c[~in_ell]).astype(np.int32), v[~in_ell])
    return col, val, spill


def ell_blocks_from_partition(part: Partition2D,
                              width: int | None = None,
                              percentile: float = 95.0,
                              cap: int = 64,
                              backend: str = "ell") -> EllBlocks | None:
    """Convert every 2D block of ``part`` to bounded-width ELL + COO spill.

    ``width=None`` chooses a capped percentile of the *per-block* row
    occupancy (a block row only holds the neighbours that fall in its
    column block, so block widths are ~1/pc of the global degree).
    Entries beyond ``width`` per (block, row) spill to that block's COO
    remainder. Under ``backend="auto"`` a level whose blocks are too small
    or would be mostly padding returns ``None`` (COO execution).
    """
    pods, pr, pc = part.pods, part.pr, part.pc
    nb, n_pad = part.nb, part.n_pad
    width = ell_width_for(part, width=width, percentile=percentile, cap=cap,
                          backend=backend)
    if width is None:
        return None
    ell_col = np.full((pods, pr, pc, nb, width), n_pad, np.int32)
    ell_val = np.zeros((pods, pr, pc, nb, width), np.float32)
    spills = []
    for p in range(pods):
        for i in range(pr):
            for j in range(pc):
                ell_col[p, i, j], ell_val[p, i, j], spill = _block_split(
                    part, p, i, j, width)
                spills.append(spill)

    spill_nnz = sum(len(s[0]) for s in spills)
    spill_cap = max(max((len(s[0]) for s in spills), default=0), 1)
    spill_row = np.full((pods, pr, pc, spill_cap), n_pad, np.int32)
    spill_col = np.full((pods, pr, pc, spill_cap), n_pad, np.int32)
    spill_val = np.zeros((pods, pr, pc, spill_cap), np.float32)
    it = iter(spills)
    for p in range(pods):
        for i in range(pr):
            for j in range(pc):
                sr, sc, sv = next(it)
                spill_row[p, i, j, : len(sr)] = sr
                spill_col[p, i, j, : len(sr)] = sc
                spill_val[p, i, j, : len(sr)] = sv

    return EllBlocks(col=ell_col, val=ell_val, spill_row=spill_row,
                     spill_col=spill_col, spill_val=spill_val,
                     width=int(width), spill_nnz=int(spill_nnz))


# ---------------------------------------------------------------------------
# One rank's block on its device.
# ---------------------------------------------------------------------------

def _on(a: np.ndarray, device) -> torch.Tensor:
    """A fresh contiguous device tensor (its own allocation, so aligned for
    the kernels' bulk copies)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def rank_block(part: Partition2D, block: tuple, device) -> dict:
    """Block ``(p, i, j)`` of ``part`` as contiguous tensors on ``device``,
    with global ids: ``row``/``col`` int32 (sentinel ``n_pad``) and
    ``val`` float32, all ``[capacity]``."""
    p, i, j = block
    row_l = part.row_local[p, i, j]
    valid = row_l < part.nb
    row = np.where(valid, i * part.nb + row_l, part.n_pad).astype(np.int32)
    col = np.where(valid, j * part.nb_col + part.col_local[p, i, j],
                   part.n_pad).astype(np.int32)
    return dict(row=_on(row, device), col=_on(col, device),
                val=_on(part.val[p, i, j], device))


def rank_ell_block(part: Partition2D, block: tuple, width: int,
                   device) -> dict:
    """Block ``(p, i, j)``'s hybrid split at ``width`` on ``device``:
    ``col``/``val`` ``[nb, width]`` (global column ids, sentinel
    ``n_pad``) and the spill ``spill_row``/``spill_col``/``spill_val``
    (global ids, only the real entries; None when the block spills
    nothing). The arrays equal that block's slices of
    :func:`ell_blocks_from_partition` at the same width."""
    col, val, (sr, sc, sv) = _block_split(part, *block, width)
    out = dict(col=_on(col, device), val=_on(val, device), spill_row=None,
               spill_col=None, spill_val=None)
    if len(sr):
        out.update(spill_row=_on(sr, device), spill_col=_on(sc, device),
                   spill_val=_on(sv, device))
    return out
