"""Port kernels on the card: each CUDA kernel against its plain version.

Needs a CUDA device and ``nvcc`` (the kernels build on first use); every
test skips without a card. It imports neither JAX nor the reference, so
it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``spmv_ell``/``jacobi`` rtol 1e-5 / atol 1e-6 against their
plain versions (the float32 summation order differs) and bitwise equal
from one call to the next; their k-column forms the same, and each column
bitwise the one-vector kernel on that column, ``agg_vote`` bit-exact (its
graph-batched form also bitwise the one-graph kernel on each graph), ``embedding_bag``
bitwise equal at hot <= 2 (a sum of two floats from 0 has one rounding)
and rtol / atol 1e-6 above (PyTorch's sum may add in another order), and
bitwise equal from one call to the next; the bag backward within 1e-6 of
each row's sum of |g| of its plain version, its accumulate form bitwise
its result added with ``add_``; DeepFM logits rtol / atol 1e-5
(the card's matrix products sum in another order). The LM family, which
runs no kernel of the port: the bf16 attention and its gradients bitwise
the plain form of the reference's block; ``moe_ffn`` bitwise on a repeat
and its routing equal to the CPU's. The dry-run's shape-only path: a real
CUDA tensor launches each wrapper's kernel, a fake CUDA tensor never
does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

from repro_torch.kernels import (bag_path, bag_tile_plan,  # noqa: E402
                                 ell_tile_plan)
from repro_torch.kernels.agg_vote import (  # noqa: E402
    vote_reduce, vote_reduce_batched, vote_reduce_batched_ref,
    vote_reduce_ref)
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    BagSum, bag_grad_layout, bag_grad_plan, bag_grad_plan_ref,
    embedding_bag_backward, embedding_bag_backward_ref, embedding_bag_kernel,
    embedding_bag_ref)
from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref  # noqa: E402
from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _ell(rng, n_rows, n_cols, width, density=0.7):
    col = rng.integers(0, n_cols, (n_rows, width)).astype(np.int32)
    val = rng.normal(size=(n_rows, width)).astype(np.float32)
    pad = rng.random((n_rows, width)) > density
    col[pad] = n_cols
    val[pad] = 0
    return col, val


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tile_rows(width):
    return ell_tile_plan(width)[0]


# (n_rows, width, padding density): the first kernels' cases, then the
# tiled design's edges: one row, a tile minus a row, a ragged last tile,
# the widest width, rows that are all padding, and many tiles a block
# (each block's ring of stages wraps several times)
CASES = [(70000, 19, 0.7), (4099, 8, 0.7), (3000, 33, 0.7), (7, 0, 0.7),
         (1, 1, 0.7), (3, 3, 0.7), (_tile_rows(19) - 1, 19, 0.7),
         (_tile_rows(34) * 7 + 5, 34, 0.7), (50_001, 64, 0.7),
         (5000, 12, 0.0), (1 << 20, 19, 0.7), (1 << 21, 3, 0.7)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,width,density", CASES)
def test_cuda_kernels_match_plain_versions(n_rows, width, density):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_rows)
    col, val = _ell(rng, n_rows, n_rows, width, density)
    x, b = (rng.normal(size=n_rows).astype(np.float32) for _ in range(2))
    deg = np.abs(rng.normal(size=n_rows)).astype(np.float32)
    deg[::7] = 0.0
    C, V, X, B, D = (_t(a).cuda() for a in (col, val, x, b, deg))
    y = spmv_ell(C, V, X)
    torch.testing.assert_close(y, spmv_ell_ref(C, V, X), rtol=RTOL,
                               atol=ATOL)
    out = jacobi_step(C, V, X, B, D)
    torch.testing.assert_close(out, jacobi_step_ref(C, V, X, B, D),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(out[::7], X[::7])             # deg == 0: x, bit for bit
    assert torch.equal(spmv_ell(C, V, X), y)         # repeat: bitwise equal
    assert torch.equal(jacobi_step(C, V, X, B, D), out)
    sq = rng.integers(0, 4, (n_rows, width)).astype(np.int32)  # many ties
    state = rng.integers(0, 3, n_rows).astype(np.int32)     # 0 = Decided
    S, Q = _t(state).cuda(), _t(sq).cuda()
    got = vote_reduce(C, Q, S, levels=1 << 20)
    want = vote_reduce_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,width", [(300, 453), (1000, 700)])
def test_cuda_rows_too_wide_to_stage_run_unstaged(n_rows, width):
    """Past width 452 two stages of a tile do not fit in shared memory:
    the plan stages nothing and the kernels (agg_vote too) read rows with
    plain loads.
    Small integers make every sum exact, so any summation order gives the
    plain version's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert ell_tile_plan(width)[1:] == (0, 0)
    rng = np.random.default_rng(width)
    col, _ = _ell(rng, n_rows, n_rows, width)
    val = rng.integers(-3, 4, (n_rows, width)).astype(np.float32)
    x = rng.integers(-8, 9, n_rows).astype(np.float32)
    b = rng.integers(-8, 9, n_rows).astype(np.float32)
    deg = 2.0 ** rng.integers(-2, 6, n_rows).astype(np.float32)
    deg[::5] = 0.0
    sq = rng.integers(0, 4, (n_rows, width)).astype(np.int32)
    state = rng.integers(0, 3, n_rows).astype(np.int32)
    C, V, X, B, D, Q, S = (_t(a).cuda()
                           for a in (col, val, x, b, deg, sq, state))
    s0, j0, v0 = spmv_ell.launches, jacobi_step.launches, vote_reduce.launches
    y, out = spmv_ell(C, V, X), jacobi_step(C, V, X, B, D)
    got = vote_reduce(C, Q, S, levels=1 << 20)
    assert (spmv_ell.launches, jacobi_step.launches,
            vote_reduce.launches) == (s0 + 1, j0 + 1, v0 + 1)
    assert torch.equal(y, spmv_ell_ref(C, V, X))
    assert torch.equal(out, jacobi_step_ref(C, V, X, B, D))
    assert torch.equal(out[::5], X[::5])
    want = vote_reduce_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


BLOCK_WIDTHS = (1, 8, 19, 34, 64)
BLOCK_KS = (1, 2, 3, 4, 8, 12, 16, 32, 64, 128)   # c = 1, 2, 4; k > 32


@pytest.mark.cuda
@pytest.mark.parametrize("width", BLOCK_WIDTHS)
@pytest.mark.parametrize("k", BLOCK_KS)
def test_cuda_block_kernels_match_column_kernels(width, k):
    """The k-column forms on row-major [n, k] blocks: column j bitwise the
    one-vector kernel on ``X[:, j]``, within tolerance of the plain
    version, bitwise on a repeat; each form counts its own launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 20_011                          # a ragged last tile at every width
    rng = np.random.default_rng(1000 * width + k)
    col, val = _ell(rng, n, n, width)
    x, b = (rng.normal(size=(n, k)).astype(np.float32) for _ in range(2))
    deg = np.abs(rng.normal(size=n)).astype(np.float32) * width
    deg[::7] = 0.0
    C, V, X, B, D = (_t(a).cuda() for a in (col, val, x, b, deg))
    s0, j0 = spmv_ell.launches, jacobi_step.launches
    sb, jb = spmv_ell.block_launches, jacobi_step.block_launches
    y, out = spmv_ell(C, V, X), jacobi_step(C, V, X, B, D)
    assert (spmv_ell.block_launches, jacobi_step.block_launches) == (sb + 1,
                                                                     jb + 1)
    assert (spmv_ell.launches, jacobi_step.launches) == (s0, j0)
    assert y.shape == out.shape == (n, k)
    torch.testing.assert_close(y, spmv_ell_ref(C, V, X), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(out, jacobi_step_ref(C, V, X, B, D),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(out[::7], X[::7])
    assert torch.equal(spmv_ell(C, V, X), y)
    assert torch.equal(jacobi_step(C, V, X, B, D), out)
    for j in range(k):
        xj, bj = X[:, j].contiguous(), B[:, j].contiguous()
        assert torch.equal(y[:, j], spmv_ell(C, V, xj)), f"spmv col {j}"
        assert torch.equal(out[:, j], jacobi_step(C, V, xj, bj, D)), \
            f"jacobi col {j}"


@pytest.mark.cuda
def test_cuda_block_arguments_checked_and_nothing_falls_back():
    """A block that the k-column kernels do not take raises before any
    launch: not contiguous, misaligned (k = 4 rows are read as float4:
    4 or 8 bytes off a 16-byte boundary; B too), no columns, another
    dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, w, k = 1000, 8, 4
    rng = np.random.default_rng(5)
    col, val = _ell(rng, n, n, w)
    C, V = _t(col).cuda(), _t(val).cuda()
    deg = torch.ones(n, device="cuda")
    X = torch.randn(n, k, device="cuda")
    buf = torch.zeros(n * k + 2, device="cuda")
    bad = {"transposed": torch.randn(k, n, device="cuda").t(),
           "misaligned": buf[1:1 + n * k].view(n, k),
           "8 bytes off": buf[2:].view(n, k),
           "no columns": torch.zeros(n, 0, device="cuda"),
           "float64": X.double(), "int32": X.int()}
    counts = lambda: (spmv_ell.launches, spmv_ell.block_launches,  # noqa: E731
                      jacobi_step.launches, jacobi_step.block_launches)
    before = counts()
    for name, Xb in bad.items():
        with pytest.raises((TypeError, ValueError)):
            spmv_ell(C, V, Xb)
        with pytest.raises((TypeError, ValueError)):
            jacobi_step(C, V, Xb, Xb, deg)
    with pytest.raises(ValueError):          # B of another shape than X
        jacobi_step(C, V, X, X[:, :2].contiguous(), deg)
    for off in (1, 2):                       # X aligned, B not
        with pytest.raises(ValueError):
            jacobi_step(C, V, X, buf[off:off + n * k].view(n, k), deg)
    assert counts() == before


@pytest.mark.cuda
def test_cuda_misaligned_table_raises_and_launches_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, w = 100, 3
    buf = torch.zeros(n * w + 4, dtype=torch.int32, device="cuda")
    col = buf[1:1 + n * w].view(n, w)                # 4 bytes off 16
    val = torch.ones((n, w), device="cuda")
    x = torch.ones(n, device="cuda")
    s0, j0, v0 = spmv_ell.launches, jacobi_step.launches, vote_reduce.launches
    with pytest.raises(ValueError):
        spmv_ell(col, val, x)
    with pytest.raises(ValueError):
        jacobi_step(col, val, x, x, x)
    with pytest.raises(ValueError):
        vote_reduce(col, col, torch.ones(n, dtype=torch.int32,
                                         device="cuda"), levels=4)
    assert (spmv_ell.launches, jacobi_step.launches,
            vote_reduce.launches) == (s0, j0, v0)


@pytest.mark.cuda
def test_cuda_launch_counts_and_width_zero():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    col = torch.zeros((5, 0), dtype=torch.int32, device="cuda")
    state = torch.ones(5, dtype=torch.int32, device="cuda")
    before = vote_reduce.launches
    k, i = vote_reduce(col, col, state, levels=4)
    assert vote_reduce.launches == before            # width 0: no launch
    assert (k == torch.iinfo(torch.int32).min).all()
    assert (i == torch.iinfo(torch.int32).max).all()
    x = torch.ones(5, device="cuda")
    n0 = spmv_ell.launches
    spmv_ell(torch.zeros((5, 1), dtype=torch.int32, device="cuda"),
             torch.ones((5, 1), device="cuda"), x)
    assert spmv_ell.launches == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["spmv_ell", "jacobi", "agg_vote",
                                     "embedding_bag", "bag_backward",
                                     "bag_grad_plan"])
def test_cuda_real_tensor_launches_fake_tensor_never(wrapper):
    """Each wrapper on real CUDA tensors launches its kernel (``launches``
    rises by one); on fake CUDA tensors (the dry-run's ``FakeTensorMode``)
    it takes the shape-only path (``fake_launches`` rises, ``launches``
    does not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import cost

    n, w, V, d = 4096, 8, 1000, 16
    i32 = torch.int32
    calls = {
        "spmv_ell": (spmv_ell, lambda z, e: spmv_ell(
            z((n, w), dtype=i32), e((n, w)), e(n))),
        "jacobi": (jacobi_step, lambda z, e: jacobi_step(
            z((n, w), dtype=i32), e((n, w)), e(n), e(n), e(n))),
        "agg_vote": (vote_reduce, lambda z, e: vote_reduce(
            z((n, w), dtype=i32), z((n, w), dtype=i32), z(n, dtype=i32),
            levels=3)),
        "embedding_bag": (embedding_bag_kernel, lambda z, e:
                          embedding_bag_kernel(e((V, d)),
                                               z((n, 2), dtype=i32))),
        "bag_backward": (embedding_bag_backward, lambda z, e:
                         embedding_bag_backward(e((n, d)),
                                                z((n, 2), dtype=i32), V)),
        "bag_grad_plan": (bag_grad_plan, lambda z, e: bag_grad_plan(
            z((n, 2), dtype=i32), V)),
    }
    fn, call = calls[wrapper]

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, device="cuda")

    before, fakes = fn.launches, fn.fake_launches
    call(zeros, randn)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and fn.fake_launches == fakes
    with cost.fake_mode():
        call(zeros, randn)
    assert fn.launches == before + 1 and fn.fake_launches == fakes + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab", [(100_003, 2, 10, 50_000),
                                                  (4099, 5, 1, 300),
                                                  (257, 1, 33, 10),
                                                  (7, 3, 10, 4)])
def test_cuda_embedding_bag_matches_plain_version(n_bags, hot, d, n_vocab):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_bags + hot)
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    idx = rng.integers(-2, n_vocab + 4, (n_bags, hot)).astype(np.int32)
    T, I = _t(table).cuda(), _t(idx).cuda()
    n0 = embedding_bag_kernel.launches
    got = embedding_bag_kernel(T, I)
    assert embedding_bag_kernel.launches == n0 + 1
    torch.testing.assert_close(got, embedding_bag_ref(T, I), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_cuda_embedding_bag_hot_zero_and_argument_checks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table = torch.ones((10, 4), device="cuda")
    n0 = embedding_bag_kernel.launches
    out = embedding_bag_kernel(table, torch.zeros((5, 0), dtype=torch.int32,
                                                  device="cuda"))
    assert embedding_bag_kernel.launches == n0        # hot 0: no launch
    assert out.shape == (5, 4) and not out.any()
    with pytest.raises(TypeError):
        embedding_bag_kernel(table, torch.zeros((5, 2), dtype=torch.int64,
                                                device="cuda"))
    # a table that requires grad is taken (BagSum differentiates the
    # kernel); the wrapper itself builds no graph
    n0 = embedding_bag_kernel.launches
    out = embedding_bag_kernel(table.requires_grad_(),
                               torch.zeros((5, 2), dtype=torch.int32,
                                           device="cuda"))
    assert embedding_bag_kernel.launches == n0 + 1
    assert out.grad_fn is None and torch.equal(out, 2 * table[:5].detach())


def _bag_grad_case(rng, n_bags, hot, d, n_vocab, skew):
    """Ids with Zipf skew (``skew``: id 0 takes about half the slots, as in
    ``recsys_batch_stream``), all one id (``"one"``) or uniform, with
    sentinels; or every slot the last id and no sentinel (``"all"``);
    output gradients N(0, 1)."""
    if skew == "all":
        idx = np.full((n_bags, hot), n_vocab - 1, np.int32)
        g = rng.normal(size=(n_bags, d)).astype(np.float32)
        return _t(g).cuda(), _t(idx).cuda()
    if skew == "one":
        idx = np.zeros((n_bags, hot), np.int32)
    elif skew:
        u = rng.random((n_bags, hot))
        idx = np.clip(np.minimum(u ** -1.1, n_vocab).astype(np.int64) - 1,
                      0, n_vocab - 1).astype(np.int32)
    else:
        idx = rng.integers(0, n_vocab, (n_bags, hot)).astype(np.int32)
    flat = idx.reshape(-1)
    flat[::7] = np.resize(np.array([-2, -1, n_vocab, n_vocab + 3], np.int32),
                          flat[::7].shape)
    g = rng.normal(size=(n_bags, d)).astype(np.float32)
    return _t(g).cuda(), _t(idx).cuda()


def _assert_bag_grad(got, G, I, n_vocab, plan=None):
    """Within 1e-6 of each row's sum of |g| of the plain version; rows no
    valid id touches exactly 0."""
    want = embedding_bag_backward_ref(G, I, n_vocab, plan)
    scale = embedding_bag_backward_ref(G.abs(), I, n_vocab, plan)
    assert ((got - want).abs() <= 1e-6 * scale + 1e-30).all()
    assert torch.equal(got[scale.sum(1) == 0],
                       torch.zeros_like(got[scale.sum(1) == 0]))


# (n_bags, hot, d, n_vocab, skew): the first cases, then widths 16 and 33
# (the general path's column tiles), a vocabulary that is not a multiple
# of the zeroed tiles (nor of a chunk), and one id in every slot
BAG_GRAD_CASES = [
    (100_003, 2, 10, 50_000, True), (65_536 * 4, 2, 1, 3_000, True),
    (4099, 5, 1, 300, False), (257, 1, 33, 10, False), (7, 3, 10, 4, True),
    (300_000, 1, 10, 5, "one"), (129, 1, 3, 1, False),
    (20_011, 3, 16, 70_001, True), (9_999, 2, 33, 12_345, False),
    (33_333, 2, 10, 1_000_003, True), (50_000, 3, 10, 777, "all"),
    (40_000, 2, 1, 1, "all")]


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab,skew", BAG_GRAD_CASES)
def test_cuda_embedding_bag_backward_matches_plain_version(
        n_bags, hot, d, n_vocab, skew):
    """The backward kernel against its plain version (a sorted segment
    sum in slot order) and bitwise equal from one launch to the next.
    Tolerance: each row's difference at most 1e-6 of the row's sum of
    |g| (a float32 sum of n terms in any two orders differs by far less
    than n·eps of that sum; the kernel sums each 256-slot chunk's runs in
    trees over the lanes, then a long run's chunks). Rows no valid id
    touches are exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_bags + d)
    G, I = _bag_grad_case(rng, n_bags, hot, d, n_vocab, skew)
    n0 = embedding_bag_backward.launches
    got = embedding_bag_backward(G, I, n_vocab)
    assert embedding_bag_backward.launches == n0 + 1
    _assert_bag_grad(got, G, I, n_vocab)
    assert torch.equal(embedding_bag_backward(G, I, n_vocab), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab,skew", BAG_GRAD_CASES)
def test_cuda_embedding_bag_backward_writes_every_row_once(
        n_bags, hot, d, n_vocab, skew):
    """Into an output filled with NaN (the wrapper's private ``_out``):
    no NaN is left, so every row was written, and the result is the bits
    of a launch into a new tensor, so no row was written twice with
    different values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_bags + d + 1)
    G, I = _bag_grad_case(rng, n_bags, hot, d, n_vocab, skew)
    out = torch.full((n_vocab, d), float("nan"), device="cuda")
    got = embedding_bag_backward(G, I, n_vocab, _out=out)
    assert got is out and not torch.isnan(out).any()
    assert torch.equal(out, embedding_bag_backward(G, I, n_vocab))
    # only sentinels: all rows 0
    only = torch.full_like(I, -1)
    only.view(-1)[1::2] = n_vocab
    out.fill_(float("nan"))
    embedding_bag_backward(G, only, n_vocab, _out=out)
    assert not out.any() and not torch.isnan(out).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab,skew", BAG_GRAD_CASES)
def test_cuda_bag_grad_plan_matches_plain_version(n_bags, hot, d, n_vocab,
                                                  skew):
    """The plan's kernel (keys, then a radix sort over the bits of [0, V])
    bitwise the plain version's stable ``torch.sort``; one launch; odd
    slot counts too (the ids view from the second slot on)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_bags + hot)
    _, I = _bag_grad_case(rng, n_bags, hot, d, n_vocab, skew)
    for ids in (I, I.reshape(-1)[1:].reshape(-1, 1)):
        n0 = bag_grad_plan.launches
        got = bag_grad_plan(ids, n_vocab)
        assert bag_grad_plan.launches == n0 + 1
        want = bag_grad_plan_ref(ids, n_vocab)
        assert torch.equal(got.sorted_ids, want.sorted_ids)
        assert torch.equal(got.rows, want.rows)
        assert (got.n_vocab, got.hot) == (want.n_vocab, want.hot)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_cuda_embedding_bag_backward_g_out_views(offset):
    """g_out starting ``offset`` floats into its buffer (4-, 8- and
    16-byte aligned: the d = 10 gathers read 8 bytes a lane where g_out
    allows, else 4) gives the bits of an aligned copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(offset)
    G, I = _bag_grad_case(rng, 30_001, 2, 10, 20_000, True)
    buf = torch.empty(G.numel() + offset, device="cuda")
    view = buf[offset:].view(G.shape)
    view.copy_(G)
    assert torch.equal(embedding_bag_backward(view, I, 20_000),
                       embedding_bag_backward(G, I, 20_000))


@pytest.mark.cuda
def test_cuda_embedding_bag_backward_shares_one_plan():
    """One plan for a d = 10 and a d = 1 call (DeepFM's two tables): each
    result bitwise that of the same call building its own plan, and one
    build in all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(11)
    n_vocab = 40_000
    G10, I = _bag_grad_case(rng, 60_000, 2, 10, n_vocab, True)
    G1 = G10[:, :1].contiguous()
    b0 = bag_grad_plan.builds
    plan = bag_grad_plan(I, n_vocab)
    got10 = embedding_bag_backward(G10, I, n_vocab, plan)
    got1 = embedding_bag_backward(G1, I, n_vocab, plan)
    assert bag_grad_plan.builds == b0 + 1
    assert torch.equal(got10, embedding_bag_backward(G10, I, n_vocab))
    assert torch.equal(got1, embedding_bag_backward(G1, I, n_vocab))
    _assert_bag_grad(got10, G10, I, n_vocab, plan)
    _assert_bag_grad(got1, G1, I, n_vocab, plan)
    with pytest.raises(ValueError):     # a plan for another vocabulary
        embedding_bag_backward(G1, I, n_vocab + 1, plan)
    assert bag_grad_layout(I.numel(), n_vocab, 10)[0] == 256


@pytest.mark.cuda
def test_cuda_bag_sum_autograd_runs_both_kernels():
    """``BagSum`` on the card: forward and backward kernels, each once, the
    gradient equal to the CPU's within rtol / atol 1e-5; sentinel-only
    bags give zero rows and no gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    table = rng.normal(size=(500, 10)).astype(np.float32)
    idx = rng.integers(-1, 502, (4000, 2)).astype(np.int32)
    idx[:5] = -1
    w = rng.normal(size=(4000, 10)).astype(np.float32)
    grads = []
    for dev in ("cpu", "cuda"):
        t = _t(table).to(dev).requires_grad_()
        f0, b0 = embedding_bag_kernel.launches, embedding_bag_backward.launches
        out = BagSum.apply(t, _t(idx).to(dev))
        assert not out[:5].any()
        (out * _t(w).to(dev)).sum().backward()
        launched = (embedding_bag_kernel.launches - f0,
                    embedding_bag_backward.launches - b0)
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads.append(t.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_deepfm_smoke_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.deepfm import SMOKE
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.models.recsys.deepfm import DeepFM

    cpu = DeepFM(SMOKE, torch.Generator().manual_seed(0), device="cpu")
    card = DeepFM(SMOKE, torch.Generator().manual_seed(0))
    idx = _t(next(recsys_batch_stream(SMOKE.vocab_per_field, 300,
                                      SMOKE.multi_hot))[1])
    n0 = embedding_bag_kernel.launches
    got = card(idx.cuda())
    assert embedding_bag_kernel.launches == n0 + 2
    torch.testing.assert_close(got.cpu(), cpu(idx), rtol=1e-5, atol=1e-5)
    cand = torch.arange(SMOKE.vocab_per_field[0], dtype=torch.int32)
    torch.testing.assert_close(
        card.retrieval_scores(idx[:1].cuda(), cand.cuda()).cpu(),
        cpu.retrieval_scores(idx[:1], cand), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_vote_main_path_shape_ragged_with_ties_and_all_decided():
    """agg_vote at the main setup's first aggregation level's shape
    (699,024 × 8: 5,461 full tiles of 128 rows and a ragged one of 16),
    with strengths in 0..3 so that many keys tie; then every neighbour
    Decided, which gives every row the identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, w = 699_024, 8
    assert n % ell_tile_plan(w)[0] != 0
    rng = np.random.default_rng(8)
    col, _ = _ell(rng, n, n, w, density=0.8)
    sq = rng.integers(0, 4, (n, w)).astype(np.int32)
    state = rng.integers(0, 3, n).astype(np.int32)
    C, Q, S = (_t(a).cuda() for a in (col, sq, state))
    v0 = vote_reduce.launches
    got = vote_reduce(C, Q, S, levels=1 << 20)
    assert vote_reduce.launches == v0 + 1
    want = vote_reduce_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, r) for g, r in zip(got, want))
    again = vote_reduce(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    k, i = vote_reduce(C, Q, torch.zeros_like(S), levels=1 << 20)
    assert (k == torch.iinfo(torch.int32).min).all()
    assert (i == torch.iinfo(torch.int32).max).all()


# (graphs, rows a graph, width): the service batch's first level (8 BA
# 2^17 graphs), groups whose graphs end inside a tile (rows a graph not a
# multiple of the tile's), the widest width, one graph, width 0
BATCHED_VOTE_CASES = [(8, 1 << 17, 8), (3, 4099, 19), (4, 1000, 64),
                      (1, 70_000, 8), (5, 777, 3), (2, 300, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_graphs,n_rows,width", BATCHED_VOTE_CASES)
def test_cuda_vote_batched_matches_plain_and_one_graph_kernel(
        n_graphs, n_rows, width):
    """The graph-batched vote on random stacked tables with hub columns
    (a few columns in a tenth of the slots), whole padding rows and
    Decided neighbours: bitwise its plain version, the one-graph kernel
    on each graph's tables and state, and itself on a repeat; one launch
    a call (none at width 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n_graphs * n_rows + width)
    cols = []
    for _ in range(n_graphs):
        col, _ = _ell(rng, n_rows, n_rows, width, density=0.8)
        hub = rng.random(col.shape) < 0.1
        col[hub] = rng.integers(0, 4, int(hub.sum()))
        col[rng.random(n_rows) < 0.05] = n_rows        # padding rows
        cols.append(col)
    sq = rng.integers(0, 4, (n_graphs, n_rows, width)).astype(np.int32)
    state = rng.integers(0, 3, (n_graphs, n_rows)).astype(np.int32)
    C, Q, S = (_t(a).cuda() for a in (np.stack(cols), sq, state))
    v0, b0 = vote_reduce.launches, vote_reduce_batched.launches
    got = vote_reduce_batched(C, Q, S, levels=1 << 20)
    assert vote_reduce_batched.launches == b0 + (1 if width else 0)
    assert vote_reduce.launches == v0
    want = vote_reduce_batched_ref(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    again = vote_reduce_batched(C, Q, S, levels=1 << 20)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g in range(n_graphs):
        one = vote_reduce(C[g].clone(), Q[g].clone(), S[g].clone(),
                          levels=1 << 20)
        assert all(torch.equal(o, b[g]) for o, b in zip(one, got))


def _bags(n_bags, hot, d, n_vocab, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    idx = rng.integers(-2, n_vocab + 3, (n_bags, hot)).astype(np.int32)
    return _t(table).cuda(), _t(idx).cuda()


def _check_bag(T, I):
    """One launch, the plain version's sums (bitwise at hot <= 2), and a
    bitwise repeat."""
    n0 = embedding_bag_kernel.launches
    got = embedding_bag_kernel(T, I)
    assert embedding_bag_kernel.launches == n0 + 1
    want = embedding_bag_ref(T, I)
    if I.shape[1] <= 2:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(embedding_bag_kernel(T, I), got)


_R = bag_tile_plan(2, 10)[0]
# (n_bags, hot, d, n_vocab): a ragged last tile, fewer bags than a tile,
# many tiles a block (each block's ring of stages wraps), d = 1, 2 and 4
# (8, 4 and 2 bags a thread), d = 33 and 1000 (the wide-row path), hot 8
BAG_CASES = [(_R * 7 + 5, 2, 10, 1000), (_R - 3, 2, 10, 1000),
             (1 << 22, 2, 10, 43_429), (100_003, 2, 1, 5000),
             (50_001, 2, 2, 900), (30_001, 3, 4, 800),
             (20_001, 1, 33, 700), (9_999, 8, 10, 3000),
             (3_001, 1, 1000, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags,hot,d,n_vocab", BAG_CASES)
def test_cuda_embedding_bag_tiles(n_bags, hot, d, n_vocab):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = bag_path(d)
    n0 = embedding_bag_kernel.paths[path]
    _check_bag(*_bags(n_bags, hot, d, n_vocab, n_bags + d))
    assert embedding_bag_kernel.paths[path] == n0 + 2


@pytest.mark.cuda
def test_cuda_embedding_bag_unstaged_long_bags():
    """Bags of 700 ids at d = 10: too large for a staged plan (0 stages:
    the narrow kernel reads ids and stores sums with plain accesses). The
    kernel sums each bag from 0 in h order, so it is bit for bit a
    float32 sum taken in that order; the plain version (PyTorch's
    reduction order) is within twice (hot − 1)·2⁻²⁴ of each sum's Σ|x|,
    the float32 error bound of two summation orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.sparse.segment import take_fill

    hot = 700
    assert bag_tile_plan(hot, 10)[1] == 0 and bag_path(10) == "narrow"
    T, I = _bags(301, hot, 10, 3000, 311)
    n0 = embedding_bag_kernel.paths["narrow"]
    got = embedding_bag_kernel(T, I)
    assert embedding_bag_kernel.paths["narrow"] == n0 + 1
    rows = take_fill(T, I, 0)                        # [301, hot, 10]
    in_order = torch.zeros_like(got)
    for h in range(hot):
        in_order = in_order + rows[:, h]
    assert torch.equal(got, in_order)
    assert torch.equal(embedding_bag_kernel(T, I), got)
    bound = 2 * (hot - 1) * 2.0 ** -24 * rows.abs().sum(1)
    assert ((got - embedding_bag_ref(T, I)).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [1, 3])
def test_cuda_embedding_bag_unaligned_ids_view(hot):
    """``I[1:]`` starts 4·hot bytes past the buffer's start, so not on a
    16-byte boundary: the kernel reads its ids with plain loads, and still
    launches once and matches the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    T, I = _bags(10_001, hot, 10, 2000, hot)
    view = I[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _check_bag(T, view)


def _ba_adj(n, seed):
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected,
                                               to_laplacian_coo)

    n, r, c, v = ensure_connected(*barabasi_albert(n, m=4, seed=seed,
                                                   weighted=True))
    return (n, r, c, v), to_laplacian_coo(n, r, c, v)


@pytest.mark.cuda
def test_cuda_superstep_steps_never_sync():
    """A super-step setup under ``torch.cuda.set_sync_debug_mode("error")``
    from the plan's start to its end, the registry cold so that the step
    builders run under it too: only ``_fetch`` and the host work after the
    last fetch lift it. One fetch per constructed level, plus the probe
    and the coarse solve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import SetupConfig

    _, adj = _ba_adj(1 << 12, 3)
    ss.clear_cache()
    ss.reset_counters()
    v0 = vote_reduce.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ss.build_hierarchy_superstep(adj,
                                         SetupConfig(matvec_backend="ell"))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert vote_reduce.launches > v0
    assert h.n_levels > 2
    assert ss.counters()["host_syncs"] <= (h.n_levels - 1) + 3


@pytest.mark.cuda
def test_cuda_superstep_equals_eager():
    """At n = 2^14 on the card: the same levels, aggregates and elimination
    masks, and bitwise the same PCG residual history and solution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    (n, r, c, v), _ = _ba_adj(1 << 14, 5)
    cfg = SetupConfig(matvec_backend="ell")
    s = LaplacianSolver.setup(n, r, c, v, cfg)
    e = LaplacianSolver.setup(n, r, c, v,
                              dataclasses.replace(cfg, setup_mode="eager"))
    keys = ("kind", "n", "nnz", "ell_width", "ell_spill")
    assert [[row[k] for k in keys] for row in s.stats()["levels"]] == \
        [[row[k] for k in keys] for row in e.stats()["levels"]]
    for ts, te in zip(s.hierarchy.transfers, e.hierarchy.transfers):
        for name in ("coarse_id", "elim_mask", "c_index", "f_index"):
            if hasattr(te, name):
                assert torch.equal(getattr(ts, name), getattr(te, name))
    b = np.random.default_rng(1).normal(size=n).astype(np.float32)
    b -= b.mean()
    xs, i_s = s.solve(b, tol=1e-6)
    xe, i_e = e.solve(b, tol=1e-6)
    assert i_s.converged and i_s.iters == i_e.iters
    assert i_s.residual_norms == i_e.residual_norms
    assert torch.equal(xs, xe)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [0, 8])
def test_cuda_segment_sum_bitwise_unchanged(cols):
    """The segment sums take their boundaries from the sorted ids and sum
    the dropped entries in chunks: on the card too every real segment's
    sum is the bits of the histogram-based form it replaced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.sparse.segment import _seg_ids, segment_sum

    rng = np.random.default_rng(cols)
    m, n_seg = 3_000_000, 200_000
    ids = _t(rng.integers(-5, int(n_seg * 1.4), m).astype(np.int32)).cuda()
    shape = (m, cols) if cols else (m,)
    data = _t(rng.normal(size=shape).astype(np.float32)).cuda()
    seg = _seg_ids(ids, n_seg)
    order = torch.argsort(seg, stable=True)
    want = torch.segment_reduce(
        data.index_select(0, order), "sum",
        lengths=torch.bincount(seg, minlength=n_seg + 1), axis=0,
        unsafe=True)[:n_seg]
    got = segment_sum(data, ids, n_seg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_facade_bitwise_pairs():
    """The facade on the card at n = 2^14: blocked columns, guards off,
    ``x0`` zeros and ``verify`` cheap / paranoid are bitwise equal to the
    plain blocked solve, whose columns are bitwise looped single solves;
    the diag-PCG rung converges on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.api import Problem, SolverOptions, setup
    from repro_torch.api.fallback import diag_pcg_block

    (n, r, c, v), _ = _ba_adj(1 << 14, 6)
    p = Problem.from_edges(n, r, c, v)
    B = np.random.default_rng(2).normal(size=(n, 4)).astype(np.float32)
    B -= B.mean(axis=0)
    solver = setup(p, SolverOptions(matvec_backend="ell", tol=1e-6),
                   cache=False)
    X, res = solver.solve(B)
    assert res.status == "converged"

    def same(a, b):
        return np.array_equal(a.view(np.int32), b.view(np.int32))

    for j in range(4):
        assert same(solver.solve(B[:, j])[0], X[:, j])
    assert same(solver._handle.solve_block(B, 1e-6, 200, guard=False)[0], X)
    assert same(solver.solve(B, x0=np.zeros_like(B))[0], X)
    for mode in ("cheap", "paranoid"):
        Xv, rv = setup(p, SolverOptions(matvec_backend="ell", tol=1e-6,
                                        verify=mode), cache=False).solve(B)
        assert same(Xv, X) and rv.certificate.passed
    _, _, _, statuses = diag_pcg_block(p, B, 1e-6, 500)
    assert statuses.tolist() == ["converged"] * 4


@pytest.mark.cuda
def test_cuda_fault_site_keeps_the_tensor_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.testing import Fault, FaultPlan, inject, site

    x = torch.ones(1000, device="cuda")
    assert site("solve.spmv", x) is x
    with inject(FaultPlan({"solve.spmv": Fault(mode="nan")})):
        y = site("solve.spmv", x)
    assert y.device == x.device and y.dtype == x.dtype
    assert int(torch.isnan(y).sum()) == 50


@pytest.mark.cuda
def test_cuda_setup_ell_sweeps_launches_spmv_ell():
    """``setup_ell_sweeps``: ``spmv_ell`` launches during a setup with the
    switch on and none with it off; the eager and super-step setups with
    it on give bitwise the same residual history."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    (n, r, c, v), _ = _ba_adj(1 << 13, 7)
    b = np.random.default_rng(3).normal(size=n).astype(np.float32)
    b -= b.mean()
    hist = {}
    for on, mode in ((False, "superstep"), (True, "superstep"),
                     (True, "eager")):
        cfg = SetupConfig(matvec_backend="ell", setup_ell_sweeps=on,
                          setup_mode=mode)
        k0 = spmv_ell.launches
        s = LaplacianSolver.setup(n, r, c, v, cfg)
        torch.cuda.synchronize()
        launched = spmv_ell.launches - k0
        assert (launched > 0) == on, (on, mode, launched)
        _, info = s.solve(b, tol=1e-6)
        assert info.converged
        hist[on, mode] = info.residual_norms
    assert hist[True, "superstep"] == hist[True, "eager"]


@pytest.mark.cuda
def test_cuda_serial_ref_runs_the_solve_kernels_and_no_vote():
    """The serial reference on the card: its solves launch ``spmv_ell`` and
    ``jacobi``, its greedy setup never launches ``agg_vote``, and it
    converges like the facade's ``serial_ref`` backend."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.api import Problem, SolverOptions, setup
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.serial_ref import serial_lamg_solver

    (n, r, c, v), _ = _ba_adj(1 << 13, 8)
    b = np.random.default_rng(4).normal(size=n).astype(np.float32)
    b -= b.mean()
    k0 = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    s = serial_lamg_solver(n, r, c, v, SetupConfig(matvec_backend="ell"))
    x, info = s.solve(b, tol=1e-6)
    torch.cuda.synchronize()
    k1 = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    assert info.converged and x.is_cuda
    assert k1[0] > k0[0] and k1[1] > k0[1] and k1[2] == k0[2]
    handle = setup(Problem.from_edges(n, r, c, v),
                   SolverOptions(matvec_backend="ell", tol=1e-6),
                   backend="serial_ref", cache=False)
    _, res = handle.solve(b)
    assert res.converged and vote_reduce.launches == k0[2]


@pytest.mark.cuda
def test_cuda_agg_registry_key_separates_ell_sweeps():
    """A second setup of the same graph with the other ``setup_ell_sweeps``
    setting adds an ``agg`` registry entry; a third, equal to the second,
    adds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import SetupConfig

    _, adj = _ba_adj(1 << 12, 9)
    ss.clear_cache()
    ss.reset_counters()
    ss.build_hierarchy_superstep(adj, SetupConfig(matvec_backend="ell"))
    entries = []
    for _ in range(2):
        ss.reset_counters()
        ss.build_hierarchy_superstep(adj, SetupConfig(
            matvec_backend="ell", setup_ell_sweeps=True))
        entries.append(ss.counters()["steps"]["agg"]["compiles"])
    assert entries[0] > 0 and entries[1] == 0


@pytest.mark.cuda
def test_cuda_dist_world_of_one_runs_the_kernels():
    """A world of one over NCCL on the card: the distributed setup and
    solve launch ``agg_vote`` and the k-column ``spmv_ell`` and ``jacobi``
    (the blocked solve runs its matvec and V-cycle on the whole block),
    converge to a host residual ≤ 1e-4 in ``single``'s iterations, and
    make every reduction an NCCL all-reduce (none staged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.dist import DistLaplacianSolver, init_world
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected)

    if dist.is_initialized():
        pytest.skip("a process group exists already")
    n, r, c, v = ensure_connected(*barabasi_albert(1 << 14, m=4, seed=3,
                                                   weighted=True))
    b = np.random.default_rng(4).normal(size=n).astype(np.float32)
    b -= b.mean()
    cfg = SetupConfig(matvec_backend="ell")
    mesh = init_world("cuda")
    try:
        k0 = (spmv_ell.block_launches, jacobi_step.block_launches,
              vote_reduce.launches)
        s = DistLaplacianSolver.setup(n, r, c, v, mesh, cfg,
                                      dist_nnz_threshold=1000)
        X, norms, iters, codes = s.solve_block(b[:, None], n_iters=200,
                                               tol=1e-6, guard=True)
        stats = mesh.stats()
    finally:
        dist.destroy_process_group()
    k1 = (spmv_ell.block_launches, jacobi_step.block_launches,
          vote_reduce.launches)
    assert all(b1 > b0 for b0, b1 in zip(k0, k1))
    assert mesh.backend == "nccl" and stats["calls"] > 0
    assert stats["staged"] == 0 and int(codes[0]) == 0
    assert len(s.level_meta) >= 1 and X.is_cuda
    _, info = LaplacianSolver.setup(n, r, c, v, cfg).solve(b, tol=1e-6)
    assert int(iters[0]) == info.iters
    x = X[:, 0].double().cpu().numpy()
    import scipy.sparse as sp

    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))
    res = b - (np.asarray(a.sum(axis=1)).ravel() * x - a @ x)
    assert np.linalg.norm(res) / np.linalg.norm(b) <= 1e-4


# (n_nodes, n_edges, d): minibatch_lg's padded sample at MeshGraphNet's,
# PNA's and EGNN's coordinates' widths, and a small graph with padding
GNN_CASES = [(169_984, 168_960, 128), (169_984, 168_960, 75),
             (169_984, 168_960, 3), (301, 1_000, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d", GNN_CASES)
def test_cuda_gnn_gather_and_scatter_match_plain_versions(n, e, d):
    """The message-passing pair on the bag kernels (bags of one id): the
    gather bitwise its plain version, the scatter within 1e-6 of each
    row's sum of |m| of its plain version, their gradients (``BagSum``,
    ``ScatterSum``) likewise, every result bitwise on a repeat; ids
    outside [0, n) (every 13th sender, every 17th receiver) gather 0 and
    are dropped from the sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.gnn.common import gather_rows, scatter_rows

    rng = np.random.default_rng(n + e + d)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    s[::13] = n
    r[::17] = n
    S, R = _t(s).cuda(), _t(r).cuda()
    X = _t(rng.normal(size=(n, d)).astype(np.float32)).cuda()
    M = _t(rng.normal(size=(e, d)).astype(np.float32)).cuda()
    plan_s = bag_grad_plan(S.view(-1, 1), n)
    plan_r = bag_grad_plan(R.view(-1, 1), n)
    n0 = embedding_bag_kernel.launches, embedding_bag_backward.launches
    got = gather_rows(X, S, plan_s)
    assert torch.equal(got, embedding_bag_ref(X, S.view(-1, 1)))
    assert torch.equal(gather_rows(X, S, plan_s), got)
    summed = scatter_rows(M, R, n, plan_r)
    _assert_bag_grad(summed, M, R.view(-1, 1), n, plan_r)
    assert torch.equal(scatter_rows(M, R, n, plan_r), summed)
    assert (embedding_bag_kernel.launches, embedding_bag_backward.launches) \
        == (n0[0] + 2, n0[1] + 2)
    G = _t(rng.normal(size=(e, d)).astype(np.float32)).cuda()
    H = _t(rng.normal(size=(n, d)).astype(np.float32)).cuda()
    grads = []
    for _ in range(2):
        x, m = X.clone().requires_grad_(), M.clone().requires_grad_()
        (gather_rows(x, S, plan_s) * G).sum().backward()
        (scatter_rows(m, R, n, plan_r) * H).sum().backward()
        grads.append((x.grad, m.grad))
    _assert_bag_grad(grads[0][0], G, S.view(-1, 1), n, plan_s)
    assert torch.equal(grads[0][1], embedding_bag_ref(H, R.view(-1, 1)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---------------------------------------------------------------------------
# the bag kernels' wide-row path (kernels.bag_path: d >= 32)
# ---------------------------------------------------------------------------

# (d, n_rows, n_edges): PNA's, MeshGraphNet's and Equiformer-v2's widths
WIDE_CASES = [(75, 3_000, 20_000), (128, 3_000, 20_000),
              (6_272, 1_500, 4_000)]


def _wide_case(d, n, e, seed):
    """Messages and node rows N(0, 1); senders uniform, every 13th the
    sentinel n; receivers: a hub (a third of the edges on row 7: a run of
    hundreds of slots, far past the 32-slot blocks), runs of exactly 32
    and 33 slots (rows 11 and 12), the rest uniform over rows 13 and up
    with every 17th a sentinel (-1, n, n + 3); edges shuffled."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    s[::13] = n
    rest = rng.integers(13, n, e - e // 3 - 65).astype(np.int32)
    rest[::17] = np.resize(np.array([-1, n, n + 3], np.int32),
                           rest[::17].shape)
    r = np.concatenate([np.full(e // 3, 7, np.int32),
                        np.full(32, 11, np.int32), np.full(33, 12, np.int32),
                        rest])
    perm = rng.permutation(e)
    X = _t(rng.normal(size=(n, d)).astype(np.float32)).cuda()
    M = _t(rng.normal(size=(e, d)).astype(np.float32)).cuda()
    return X, M, _t(s[perm]).cuda().view(-1, 1), _t(r[perm]).cuda().view(-1, 1)


def _offset_view(t, offset=1):
    """``t``'s values in a view ``offset`` floats into a larger buffer (not
    16-byte aligned: the kernels then take 4-byte loads)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,e", WIDE_CASES)
def test_cuda_wide_gather_is_bitwise_its_plain_version(d, n, e):
    """The gather's wide path (one launch each): bags of one id bitwise the
    plain version and on a repeat, ids outside [0, n) giving 0; the same
    bits from a misaligned table view and a misaligned ids view; hot 2
    bitwise too (a sum of two floats from 0 has one rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, _, S, _ = _wide_case(d, n, e, d + 1)
    w0 = embedding_bag_kernel.paths["wide"]
    _check_bag(X, S)
    assert embedding_bag_kernel.paths["wide"] == w0 + 2
    got = embedding_bag_kernel(X, S)
    assert torch.equal(embedding_bag_kernel(_offset_view(X), S), got)
    assert torch.equal(embedding_bag_kernel(X, S[1:]), got[1:])
    _check_bag(X, S.view(-1)[: e // 2 * 2].view(-1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,e", WIDE_CASES)
def test_cuda_wide_scatter_matches_plain_and_writes_every_row(d, n, e):
    """The backward's wide path: within 1e-6 of each row's sum of |m| of
    the plain version (rows no valid id touches exactly 0), bitwise on a
    repeat, every row written once (into a NaN-filled ``_out``), the same
    bits from a misaligned messages view; a hub far longer than a block
    and runs of 32 and 33 slots among the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, M, _, R = _wide_case(d, n, e, d + 2)
    plan = bag_grad_plan(R, n)
    counts = torch.bincount(plan.sorted_ids.long(), minlength=n + 1)[:n]
    assert int(counts[7]) > 32 * 8 and counts[11:13].tolist() == [32, 33]
    w0 = embedding_bag_backward.paths["wide"]
    got = embedding_bag_backward(M, R, n, plan)
    assert embedding_bag_backward.paths["wide"] == w0 + 1
    _assert_bag_grad(got, M, R, n, plan)
    assert torch.equal(embedding_bag_backward(M, R, n, plan), got)
    out = torch.full((n, d), float("nan"), device="cuda")
    assert embedding_bag_backward(M, R, n, plan, _out=out) is out
    assert torch.equal(out, got)
    assert torch.equal(embedding_bag_backward(_offset_view(M), R, n, plan),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,e", WIDE_CASES + [(10, 3_000, 20_000)])
def test_cuda_accumulate_form_is_bitwise_add_of_the_scatter(d, n, e):
    """The accumulate form (``acc=``) bitwise ``acc.add_(scatter)`` at the
    wide widths, in place, untouched rows left as they were, from an
    aligned and a misaligned ``acc`` and messages view; at d = 10 (a
    narrow width, which the form also sends down the wide path) within
    1e-6 of each row's sum of |m| of the plain version. ``ScatterAdd``
    on the card: the gradient of ``acc`` the incoming one, that of the
    messages the gather of it, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, M, _, R = _wide_case(d, n, e, d + 3)
    plan = bag_grad_plan(R, n)
    part = embedding_bag_backward(M, R, n, plan)
    want = X + embedding_bag_backward_ref(M, R, n, plan)
    scale = embedding_bag_backward_ref(M.abs(), R, n, plan)
    a0 = embedding_bag_backward.paths["wide_accumulate"]
    for acc, msgs in ((X.clone(), M), (_offset_view(X), _offset_view(M))):
        got = embedding_bag_backward(msgs, R, n, plan, acc=acc)
        assert got is acc
        if d >= 32:
            assert torch.equal(got, X.clone().add_(part))
        else:       # the sums' tolerance, and one rounding of the add
            assert ((got - want).abs()
                    <= 1e-6 * scale + 2.4e-7 * want.abs()).all()
    assert embedding_bag_backward.paths["wide_accumulate"] == a0 + 2
    untouched = ~torch.isin(torch.arange(n, device="cuda"),
                            plan.sorted_ids.long())
    assert untouched.any() and torch.equal(got[untouched], X[untouched])
    if d < 32:
        return
    from repro_torch.kernels.embedding_bag import ScatterAdd

    up = torch.randn((n, d), device="cuda")
    acc, m = X.clone().requires_grad_(), M.clone().requires_grad_()
    s = acc * 1.0
    (ScatterAdd.apply(s, m, R, n, plan) * up).sum().backward()
    assert torch.equal(acc.grad, up)
    assert torch.equal(m.grad, embedding_bag_ref(up, R))


@pytest.mark.cuda
def test_cuda_equiformer_chunk_sums_bitwise_the_add_form():
    """Equiformer-v2 at SMOKE widths (3 layers, 4 edge chunks, remat) on
    the card: the loss and every gradient with each chunk added into the
    running sum by the kernel bit for bit those of the chunked ``add_``
    form, the accumulate form launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    import repro_torch.models.gnn.equiformer as TE
    from repro_torch.configs import equiformer_v2
    from repro_torch.models.gnn.common import GraphBatch
    from repro_torch.tree import leaves, value_and_grad

    cfg, init, fwd = equiformer_v2.make_model("smoke", 12)
    cfg = dataclasses.replace(cfg, n_layers=3, edge_chunk_size=64,
                              remat=True)
    rng = np.random.default_rng(21)
    n, e = 120, 250
    g = GraphBatch(
        senders=_t(rng.integers(0, n, e).astype(np.int32)).cuda(),
        receivers=_t(rng.integers(0, n, e).astype(np.int32)).cuda(),
        node_feat=_t(rng.normal(size=(n, 12)).astype(np.float32)).cuda(),
        pos=_t(rng.normal(size=(n, 3)).astype(np.float32)).cuda(),
    ).with_plans(edge_chunk=64)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(3),
                  "cuda")
    real = TE.scatter_rows

    def add_form(msgs, idx, n_rows, plan=None, acc=None, reduce=True):
        part = real(msgs, idx, n_rows, plan, reduce=reduce)
        return part if acc is None else acc.add_(part)

    runs = []
    for form in (real, add_form):
        TE.scatter_rows = form
        try:
            a0 = embedding_bag_backward.paths["wide_accumulate"]
            val, grads = value_and_grad(
                lambda p: torch.mean(torch.square(fwd(cfg, p, g))), params)
            torch.cuda.synchronize()
            runs.append((val, leaves(grads),
                         embedding_bag_backward.paths["wide_accumulate"]
                         - a0))
        finally:
            TE.scatter_rows = real
    (v0, g0, acc0), (v1, g1, acc1) = runs
    assert acc0 > 0 and acc1 == 0
    assert torch.equal(v0, v1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# the LM family on the card (no kernel of the port: cuBLAS and plain ops)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S,T,dh,offset,chunk", [
    (2048, 2048, 64, 0, 1024),   # sqrt(dh) = 8: the queries are scaled
    (256, 256, 128, 0, 64),      # sqrt(dh) ≈ 11.3: the scores are divided
    (128, 640, 64, 512, 64),     # an offset against a longer key row
    (1, 4096, 128, 4095, 1024),  # one decoded token, a full cache
])
def test_cuda_attention_bf16_is_bitwise_the_plain_form(S, T, dh, offset,
                                                       chunk):
    """``gqa_attention`` in bfloat16 and its gradients, bit for bit the
    plain transcription of the reference's block (``torch_lm_helpers``):
    the query scaling by a power of two and the in-place causal fill
    change no bit on the card either."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.transformer import gqa_attention
    from torch_lm_helpers import plain_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, d = (torch.randn((2, S, 14, dh), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, T, 2, dh), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    runs = []
    for fn in (lambda *a: gqa_attention(*a, causal_offset=offset,
                                        q_chunk=chunk),
               lambda *a: plain_attention(*a, offset, chunk)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        runs.append((out, *torch.autograd.grad(out, leaves, d)))
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(*runs))


@pytest.mark.cuda
def test_cuda_moe_ffn_bitwise_and_routing_equals_the_cpu():
    """``moe_ffn`` at moonshot-v1-16b-a3b's FULL widths (d 2,048, 64
    experts of 1,408, top-6, 2 shared) in bfloat16 on 384 tokens: the
    forward and every gradient bit for bit on a repeat; and the routing
    ``(idx, pos, keep)`` equal to the CPU's on the same tensors. Inputs
    and router are small integers times powers of two (every logit a
    multiple of 1/4, exact on both devices), so ties are many and the
    comparison tests the rule, not a product's rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs.moonshot_v1_16b_a3b import FULL
    from repro_torch.models.sharding import null_plan
    from repro_torch.models.transformer import moe_ffn, moe_route

    m, d = FULL.moe, FULL.d_model
    f, E = m.d_ff_expert, m.n_experts
    rng = np.random.default_rng(11)
    x = rng.integers(-2, 3, (2, 192, d)).astype(np.float32)
    router = np.zeros((d, E), np.float32)
    for e in range(E):
        router[rng.choice(d, 2, replace=False), e] = rng.integers(-1, 2, 2) / 4
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = dict(moe_gate=(E, d, f), moe_up=(E, d, f), moe_down=(E, f, d),
                  shared_gate=(d, 2 * f), shared_up=(d, 2 * f),
                  shared_down=(2 * f, d))
    lw = {k: (0.02 * torch.randn(s, generator=gen, device="cuda")).to(
        torch.bfloat16) for k, s in shapes.items()}
    lw["router"] = _t(router).cuda().to(torch.bfloat16)
    X = _t(x).cuda().to(torch.bfloat16)
    up = torch.randn(X.shape, generator=gen, device="cuda").to(X.dtype)
    runs = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_() for k, v in lw.items()}
        xi = X.clone().requires_grad_()
        out = moe_ffn(xi, leaves, m, null_plan())
        out.backward(up)
        runs.append([out.detach(), xi.grad] + [leaves[k].grad
                                              for k in sorted(leaves)])
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(*runs))
    assert all(torch.isfinite(t).all() and t.abs().sum() > 0
               for t in runs[0])
    xt = X.reshape(1, -1, d)
    card = moe_route(xt, lw["router"], m)
    host = moe_route(xt.cpu(), lw["router"].cpu(), m)
    top = torch.sort(host.probs, dim=-1, descending=True).values
    assert (top[..., m.top_k - 1] == top[..., m.top_k]).any()   # ties
    assert not host.keep.all()                                  # drops
    for name in ("idx", "pos", "keep"):
        assert torch.equal(getattr(card, name).cpu(), getattr(host, name))
    assert card.cap == host.cap
