"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper runs its CUDA kernel on CUDA tensors and its plain version on
CPU tensors, and only there; it counts its kernel launches in a plain int
attribute, ``<wrapper>.launches`` (the ELL kernels' k-column form, on
``[n, k]`` blocks, in ``<wrapper>.block_launches``).

On fake tensors (the dry-run's ``FakeTensorMode``, ``repro_torch.launch``)
a wrapper takes a shape-only path instead, whatever their device: it
returns an empty result of the kernel's shapes, computes nothing,
launches nothing (never the plain version either) and counts the call in
``<wrapper>.fake_launches``, not in ``launches``. Every launch, real or
shape-only, reports the bytes the kernel must move (counted from its
shapes as ``PERF.md`` counts its bound) to the dry-run's innermost
counter, if one runs (:data:`COUNTERS`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the dry-run's running counters (``launch.cost.count``), innermost last
COUNTERS: list = []
_LIB = None


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on the card, False when every tensor is on
    the CPU; raises on anything else (mixed devices, other backends)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"{name}: tensors must all be on CUDA or all on the "
                     f"CPU, got {sorted(kinds)}")


def is_fake(*tensors: torch.Tensor) -> bool:
    """True when a tensor is fake (``FakeTensorMode``): the dry-run traces
    its shapes only. (A ``meta`` tensor is not fake: the wrappers refuse
    it, as they refuse every device but the card and the CPU.)"""
    from torch._subclasses.fake_tensor import is_fake as fake

    return any(fake(t) for t in tensors)


def note(name: str, nbytes: int) -> None:
    """Report one launch of kernel ``name`` and its bytes to the innermost
    running dry-run counter, if any."""
    if COUNTERS:
        COUNTERS[-1].note_kernel(name, nbytes)


def shape_only(wrapper, name: str, nbytes: int, out, block: bool = False):
    """A wrapper's shape-only path: ``out`` (its empty result), the call
    counted in ``wrapper.fake_launches`` (``block_fake_launches`` for the
    k-column form of the ELL kernels) and noted with ``nbytes``."""
    if block:
        wrapper.block_fake_launches += 1
    else:
        wrapper.fake_launches += 1
    note(name, nbytes)
    return out


def lib():
    """The kernel library, looked up once (built on first use)."""
    global _LIB
    if _LIB is None:
        from repro_torch.kernels._build import library

        _LIB = library()
    return _LIB


def launch(t: torch.Tensor, fn, *args) -> int:
    """``fn(*args, stream)`` on ``t``'s stream; under ``t``'s device only
    when that is not the current one (a launch runs on the current
    device)."""
    if t.device.index == torch.cuda.current_device():
        return fn(*args, stream_of(t))
    with torch.cuda.device(t.device):
        return fn(*args, stream_of(t))


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_aligned(name: str, t: torch.Tensor, align: int = 16) -> None:
    """Raise unless ``t``'s data starts on an ``align``-byte boundary (a
    bulk copy's source must be 16-B aligned)."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data must be {align}-byte aligned")


# an H100 block's shared memory (232,448 B), less 1 KB kept for the
# kernel's static shared memory (its mbarriers)
SMEM_PER_BLOCK = 232_448 - 1024
_TILE_ROWS = 128                # rows of a tile, one a consumer thread ...
_TILE_MAX_BYTES = 32 * 1024     # ... halved while col + val pass this,
_TILE_MIN_BYTES = 8 * 1024      # doubled (rows a thread) while under this


def ell_tile_plan(width: int) -> tuple[int, int, int]:
    """The tile plan of the float ELL kernels (``csrc/ell_tiles.cuh``) at
    ``width``: ``(rows_per_tile, stages, smem_bytes)``.

    A tile is R rows of both tables (8·width bytes a row), R a power of
    two from 32 to 2048: 128 rows, one a consumer thread, halved while a
    tile would pass 32 KB and doubled (several rows a thread) while it
    would stay under 8 KB. Two stages: the copy of one tile overlaps the
    use of the other. The kernels' speed follows the consumer threads
    resident on an SM (their gathers set the pace once the stream is
    staged), so the plan keeps a block's shared memory small: on an H100
    more stages or larger tiles were slower at widths 19, 34 and 64
    (PERF.md). Width 0 stages nothing. Where two stages of 32 rows would
    not fit in a block's shared memory (width > 452; the solver's widths
    stop at ``select_ell_width``'s cap, 64 by default), the plan has no
    stages either: the kernels read every row with plain loads.
    """
    if width < 0:
        raise ValueError(f"ell_tile_plan: negative width {width}")
    row_bytes = 8 * width
    rows = _TILE_ROWS
    while rows > 32 and rows * row_bytes > _TILE_MAX_BYTES:
        rows //= 2
    while 0 < rows * row_bytes < _TILE_MIN_BYTES and rows < 2048:
        rows *= 2
    smem = 2 * rows * row_bytes
    if width == 0 or smem > SMEM_PER_BLOCK:
        return _TILE_ROWS, 0, 0
    return rows, 2, smem


_BLOCK_THREADS = 256            # consumer threads of a block, at most
_BLOCK_PARTIALS = 16            # partial sums a thread holds: (P / T)·c
_BLOCK_RING_BYTES = 16 * 1024   # stages added (2 to 8) while the ring is less


class BlockTilePlan(NamedTuple):
    """The tile plan of the ELL kernels' k-column form; see
    :func:`ell_block_tile_plan`."""

    rows_per_tile: int
    stages: int
    smem_bytes: int
    cols: int           # c: the contiguous columns of a unit
    unit_threads: int   # T: the threads that split a row's lanes
    threads: int        # consumer threads of a block


def ell_lanes(width: int) -> int:
    """P, the lanes of a row sum of ``width`` slots in the ELL kernels'
    order (``csrc/ell_tiles.cuh`` ``row_sum``): the largest power of two
    <= ``width``, at most 32 (1 at widths 0 and 1)."""
    return min(1 << (max(width, 1).bit_length() - 1), 32)


def ell_block_tile_plan(width: int, k: int) -> BlockTilePlan:
    """The tile plan of the float ELL kernels' k-column form
    (``csrc/ell_tiles.cuh`` ``block_tiles_kernel``) at ``width`` and ``k``
    columns.

    A unit of work is a (row, group of c contiguous columns): c = 4 where
    ``k % 4 == 0`` (a row of the block is then 16-byte aligned), 2 where
    ``k`` is even, else 1. T threads of one warp own a unit and split the
    row's P lanes (:func:`ell_lanes`), P/T each: T is the fewest, a power
    of two, that keep a thread's (P/T)·c partial sums within 16. A row is
    (k/c)·T threads; a tile is the largest multiple of 4 rows whose units
    give each of 256 consumer threads at most two, in turn, and whose
    tables stay within 32 KB (4 rows at least, a thread then taking more
    units in turn: a row of more than 64 threads), so that the bulk copies
    of a tile are 16-byte multiples; on an H100, two units a thread ran
    4–7 % faster than one at k = 8 and 64 and alike at k = 4 (PERF.md).
    The consumer threads are the tile's units' threads rounded up to
    warps, at most 256. Stages: two, more (up to 8) while the ring would
    hold less than 16 KB, so that small tiles still keep a stream in
    flight. Width 0, or two stages beyond a block's shared memory: no
    stages (plain loads)."""
    if width < 0 or k < 1:
        raise ValueError(f"ell_block_tile_plan: width {width}, k {k}")
    lanes = ell_lanes(width)
    cols = 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1
    unit_threads = max(1, lanes * cols // _BLOCK_PARTIALS)
    row_threads = (k // cols) * unit_threads
    rows = max(4, min(2 * (_BLOCK_THREADS // row_threads),
                      _TILE_MAX_BYTES // (8 * max(width, 1))) // 4 * 4)
    threads = min(_BLOCK_THREADS, -(-rows * row_threads // 32) * 32)
    tile = 8 * rows * width
    stages = min(8, max(2, -(-_BLOCK_RING_BYTES // max(tile, 1))))
    if width == 0 or 2 * tile > SMEM_PER_BLOCK:
        return BlockTilePlan(rows, 0, 0, cols, unit_threads, threads)
    return BlockTilePlan(rows, stages, stages * tile, cols, unit_threads,
                         threads)


_BAG_THREADS = 256              # consumer threads of a block, halved ...
_BAG_TILE_MAX_BYTES = 32 * 1024  # ... while ids + sums of a tile pass this
_BAG_STAGES = 3                 # tiles of ids in the ring


def bag_tile_plan(hot: int, d: int) -> tuple[int, int, int]:
    """The tile plan of the embedding-bag kernel (``csrc/embedding_bag.cu``)
    for ``hot`` ids a bag and rows of ``d`` floats: ``(bags_per_tile,
    stages, smem_bytes)``.

    A consumer thread sums K bags of a tile: K = 8 // C for rows of up to
    8 floats (C, the power of two >= d, the floats of a row it gathers at
    once), else 1, so that it issues 8–16 floats of gathers at once. A
    tile is 256 threads' bags, halved (down to 32 threads) while its ids
    and sums (4·(hot + d) bytes a bag) would pass 32 KB. Three stages of
    ids (R·hot·4 bytes each, a multiple of 16 since R is a multiple of
    32: on an H100 three ran 3–9 % faster than two at DeepFM's shapes,
    PERF.md) and two buffers of sums (R·d·4 bytes each), so that the
    copies of the next tiles' ids and the store of one tile's sums overlap
    the work on a tile. Where that would not fit in a block's shared
    memory, or there is nothing to sum (hot or d 0), the plan has no
    stages: the kernel reads ids and stores sums with plain loads and
    stores.
    """
    if hot < 0 or d < 0:
        raise ValueError(f"bag_tile_plan: negative shape ({hot}, {d})")
    per_thread = 8 // (1 << (d - 1).bit_length()) if 0 < d <= 8 else 1
    bag_bytes = 4 * (hot + d)
    threads = _BAG_THREADS
    while threads > 32 and threads * per_thread * bag_bytes \
            > _BAG_TILE_MAX_BYTES:
        threads //= 2
    bags = threads * per_thread
    smem = 4 * bags * (_BAG_STAGES * hot + 2 * d)
    if hot == 0 or d == 0 or smem > SMEM_PER_BLOCK:
        return bags, 0, 0
    return bags, _BAG_STAGES, smem


# rows of at least this many floats take the bag kernels' wide-row path
BAG_WIDE_MIN_D = 32


def bag_path(d: int) -> str:
    """The path of the bag kernels (``csrc/embedding_bag.cu`` and
    ``csrc/embedding_bag_backward.cu``) for rows of ``d`` floats:
    ``"wide"`` from :data:`BAG_WIDE_MIN_D` floats on, where a row fills a
    warp's 32 lanes with at least one float each (the GNNs' d = 75 and
    128, Equiformer-v2's 6,272), else ``"narrow"`` (DeepFM's d = 10 and 1,
    the segment softmax's 8, EGNN's coordinates' 3). The narrow path is
    the tiled one above (``bag_tile_plan``; in the backward, a lane's 8
    sorted slots); the wide path splits a row over a warp's lanes and a
    wide row over several warps. The accumulate form of the backward
    always takes the wide path."""
    if d < 0:
        raise ValueError(f"bag_path: negative width {d}")
    return "wide" if d >= BAG_WIDE_MIN_D else "narrow"
