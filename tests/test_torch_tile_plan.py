"""The tile plans of the staged kernels.

``repro_torch.kernels.ell_tile_plan(width)`` sizes the tiles of the ELL
kernels (``csrc/ell_tiles.cuh``: spmv_ell, jacobi, agg_vote) and
``bag_tile_plan(hot, d)`` those of the embedding bag
(``csrc/embedding_bag.cu``): the wrappers pass their ``(rows, stages,
smem_bytes)`` to the C entry points, which refuse a plan that breaks these
rules. Checked here, without a card, for every width the solver can select
(0 … 64, ``select_ell_width``'s cap), for the bag shapes of the port's
models and tests, and past what fits; and that the kernels' build hashes
every source and header. ``bag_path(d)`` picks the bag kernels' path
(the tiles above, or the wide-row split over a warp's lanes) from ``d``.
"""

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

from repro_torch.kernels import (SMEM_PER_BLOCK, bag_path,  # noqa: E402
                                 bag_tile_plan, ell_tile_plan)

H100_SMEM_PER_BLOCK = 232_448


@pytest.mark.parametrize("width", range(65))
def test_ell_tile_plan_rules(width):
    rows, stages, smem = ell_tile_plan(width)
    assert rows % 4 == 0 and (rows * width * 4) % 16 == 0  # bulk copies
    assert smem <= SMEM_PER_BLOCK <= H100_SMEM_PER_BLOCK
    threads = min(rows, 256)                 # consumer threads of a block
    assert threads % 32 == 0 and rows % threads == 0
    if width:
        assert 2 <= stages <= 8
        assert smem == stages * rows * width * 8
    else:
        assert (stages, smem) == (0, 0)      # width 0 stages nothing
    assert ell_tile_plan(width) == (rows, stages, smem)


def test_ell_tile_plan_refuses_what_does_not_fit():
    """A negative width is refused; rows too wide for two stages of a
    32-row tile in shared memory (width > 452) get a plan that stages
    nothing, which the kernels read with plain loads."""
    rows, stages, smem = ell_tile_plan(452)
    assert (rows, stages) == (32, 2) and smem <= SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        ell_tile_plan(-1)
    for width in (453, 700, 4096):
        rows, stages, smem = ell_tile_plan(width)
        assert (stages, smem) == (0, 0)
        assert rows % 32 == 0 and rows <= 256


def test_build_hashes_every_kernel_source_and_header():
    """The library's cache name hashes ``SOURCES`` and ``HEADERS`` only, so
    a kernel file left out of them would leave a stale build in place."""
    from repro_torch.kernels import _build

    assert set(_build.SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
    assert set(_build.HEADERS) == {p.name for p in _build.CSRC.glob("*.cuh")}
    assert "ell_tiles.cuh" in _build.HEADERS
    assert "bulk_copy.cuh" in _build.HEADERS
    assert "row_slabs.cuh" in _build.HEADERS


# (hot, d): DeepFM's bags and first-order weights (2, 10) and (2, 1), the
# card tests' shapes, and the widest rows that still fit
BAG_SHAPES = [(1, 1), (2, 1), (2, 2), (3, 4), (2, 10), (3, 10), (5, 1),
              (1, 33), (8, 10), (2, 64), (1, 256), (16, 16), (64, 1),
              (1, 902), (2, 900)]


def _bags_per_thread(d):
    """The kernel's rule: K = 8 // C bags a thread for rows of up to 8
    floats (C the power of two >= d), else 1."""
    return next(8 // c for c in (1, 2, 4, 8) if d <= c) if d <= 8 else 1


@pytest.mark.parametrize("hot,d", BAG_SHAPES)
def test_bag_tile_plan_rules(hot, d):
    bags, stages, smem = bag_tile_plan(hot, d)
    k = _bags_per_thread(d)
    threads = bags // k                      # consumer threads of a block
    assert bags == threads * k
    assert 32 <= threads <= 256 and threads % 32 == 0
    assert (bags * hot * 4) % 16 == 0        # a bulk copy of ids
    assert (32 * k * d * 4) % 16 == 0        # a warp's bulk store of sums
    assert 2 <= stages <= 8
    assert smem == stages * bags * hot * 4 + 2 * bags * d * 4
    assert smem <= SMEM_PER_BLOCK
    assert bags * 4 * (hot + d) <= 32 * 1024 or threads == 32
    assert bag_tile_plan(hot, d) == (bags, stages, smem)


def test_bag_tile_plan_zero_stages_where_nothing_fits_or_is_summed():
    """Rows too wide for the stages of ids and two buffers of sums at 32
    bags, and nothing to sum (hot or d 0), get a plan of 0 stages: the
    kernel reads ids and stores sums with plain accesses."""
    assert bag_tile_plan(1, 902)[1] > 0
    for hot, d in ((1, 903), (1, 904), (8, 1000), (0, 10), (2, 0), (0, 0)):
        bags, stages, smem = bag_tile_plan(hot, d)
        assert (stages, smem) == (0, 0)
        assert bags % 32 == 0
    with pytest.raises(ValueError):
        bag_tile_plan(-1, 10)
    with pytest.raises(ValueError):
        bag_tile_plan(2, -1)


# (d, path): DeepFM's d = 1 and 10, EGNN's coordinates' 3 and the segment
# softmax's 8 keep the tiled path; PNA's 75, MeshGraphNet's 128 and
# Equiformer-v2's 6,272 take the wide-row path, from 32 floats on
@pytest.mark.parametrize("d,path", [
    (1, "narrow"), (3, "narrow"), (8, "narrow"), (10, "narrow"),
    (31, "narrow"), (32, "wide"), (75, "wide"), (128, "wide"),
    (6_272, "wide"), (0, "narrow")])
def test_bag_path_by_width(d, path):
    assert bag_path(d) == path


def test_bag_path_refuses_a_negative_width():
    with pytest.raises(ValueError):
        bag_path(-1)
