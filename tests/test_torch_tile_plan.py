"""The tile plan of the float ELL kernels (``csrc/ell_tiles.cuh``).

``repro_torch.kernels.ell_tile_plan(width)`` is the one place that sizes
the kernels' tiles: the wrappers pass its ``(rows_per_tile, stages,
smem_bytes)`` to the C entry points, which refuse a plan that breaks
these rules. Checked here, without a card, for every width the solver can
select (0 … 64, ``select_ell_width``'s cap), and past what fits; and
that the kernels' build hashes the header that holds them.
"""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import SMEM_PER_BLOCK, ell_tile_plan  # noqa: E402

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
