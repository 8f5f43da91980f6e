"""The bag backward's plan (one id sort a batch, shared by DeepFM's two
tables), on the CPU.

* ``bag_grad_plan`` against numpy's stable argsort of the keyed ids (ids
  outside ``[0, V)`` keyed ``V``), its rows equal to ``slot // hot``:
  sentinels −2, −1, V and V + 3, all ids invalid, V = 1, hot 1–5, Zipf
  skew, no bags;
* the plain backward with a plan bitwise the plain backward without one,
  and ``BagSum`` with and without a plan giving the same gradients;
* DeepFM: one plan built a forward with grad and none under
  ``torch.no_grad()``; the loss and every gradient over the shared plan
  against ``jax.value_and_grad`` (rtol / atol 1e-5, as in
  ``test_torch_train.py``: the float32 matrix products sum in another
  order);
* the kernel's layouts (``bag_grad_layout``, and ``bag_wide_layout`` of
  its wide-row path);
* the accumulate form's plain version bitwise ``acc + embedding_bag_
  backward_ref(...)`` (ids outside ``[0, V)``, a hub run, untouched rows
  kept), and ``ScatterAdd``'s values and gradients bitwise those of
  ``ScatterSum`` followed by ``add_``;
* the profiler's names of both paths' device kernels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deepfm as jcfg  # noqa: E402
from repro.data.synthetic import recsys_batch_stream as j_stream  # noqa: E402
from repro.models.recsys import deepfm as jd  # noqa: E402
from repro_torch.configs import deepfm as tcfg  # noqa: E402
from repro_torch.convert import deepfm_params_from_numpy  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    BagSum, ScatterAdd, ScatterSum, bag_grad_layout, bag_grad_plan,
    bag_wide_layout, embedding_bag_backward, embedding_bag_backward_ref,
    embedding_bag_kernel)
from repro_torch.models.recsys import deepfm as td  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
NARROW39 = dict(n_fields=39, embed_dim=10, mlp_sizes=(32, 32),
                vocab_per_field=jd.default_vocabs(39, scale=1e-3),
                multi_hot=2)
CONFIGS = {"smoke": (jcfg.SMOKE, tcfg.SMOKE),
           "narrow39": (jd.DeepFMConfig(**NARROW39),
                        td.DeepFMConfig(**NARROW39))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(rng, n_bags, hot, n_vocab, kind):
    """``zipf``: Zipf-like ids (id 0 takes about half) with every fifth
    slot a sentinel (−2, −1, V, V + 3); ``uniform``: uniform ids, no
    sentinel; ``invalid``: sentinels only."""
    if kind == "invalid":
        return np.resize(np.array([-2, -1, n_vocab, n_vocab + 3], np.int32),
                         (n_bags, hot))
    if kind == "uniform":
        return rng.integers(0, n_vocab, (n_bags, hot)).astype(np.int32)
    u = rng.random((n_bags, hot))
    idx = np.clip(np.minimum(u ** -1.1, n_vocab).astype(np.int64) - 1, 0,
                  n_vocab - 1).astype(np.int32)
    flat = idx.reshape(-1)
    flat[::5] = np.resize(np.array([-2, -1, n_vocab, n_vocab + 3], np.int32),
                          flat[::5].shape)
    return idx


PLAN_CASES = [(300, 1, 37, "zipf"), (300, 2, 37, "zipf"),
              (200, 3, 1000, "zipf"), (128, 4, 5, "zipf"),
              (97, 5, 37, "zipf"), (64, 2, 37, "invalid"),
              (50, 3, 1, "zipf"), (50, 2, 1, "uniform"),
              (1000, 2, 50, "uniform"), (0, 2, 9, "zipf")]


@pytest.mark.parametrize("n_bags,hot,n_vocab,kind", PLAN_CASES)
def test_bag_grad_plan_matches_numpy_stable_argsort(n_bags, hot, n_vocab,
                                                    kind):
    rng = np.random.default_rng(n_bags + hot)
    idx = _ids(rng, n_bags, hot, n_vocab, kind)
    flat = idx.reshape(-1)
    key = np.where((flat >= 0) & (flat < n_vocab), flat, n_vocab)
    order = np.argsort(key, kind="stable")
    b0 = bag_grad_plan.builds
    plan = bag_grad_plan(_t(idx), n_vocab)
    assert bag_grad_plan.builds == b0 + 1
    assert plan.sorted_ids.dtype == plan.rows.dtype == torch.int32
    assert (plan.n_vocab, plan.hot) == (n_vocab, hot)
    np.testing.assert_array_equal(plan.sorted_ids.numpy(), key[order])
    np.testing.assert_array_equal(plan.rows.numpy(), order // hot)


@pytest.mark.parametrize("d", [1, 4, 10])
@pytest.mark.parametrize("kind", ["zipf", "uniform", "invalid"])
def test_plain_backward_with_a_plan_is_bitwise_without_one(d, kind):
    rng = np.random.default_rng(d)
    n_vocab = 41
    idx = _t(_ids(rng, 333, 3, n_vocab, kind))
    g = _t(rng.normal(size=(333, d)).astype(np.float32))
    plan = bag_grad_plan(idx, n_vocab)
    without = embedding_bag_backward_ref(g, idx, n_vocab)
    assert torch.equal(embedding_bag_backward_ref(g, idx, n_vocab, plan),
                       without)
    # the CPU wrapper is the plain version, with the plan too
    assert torch.equal(embedding_bag_backward(g, idx, n_vocab, plan),
                       without)
    out = torch.full((n_vocab, d), float("nan"))
    assert embedding_bag_backward(g, idx, n_vocab, plan, _out=out) is out
    assert torch.equal(out, without)


@pytest.mark.parametrize("d", [1, 10])
def test_bag_sum_with_and_without_a_plan_same_gradients(d):
    rng = np.random.default_rng(5 + d)
    n_vocab = 60
    idx = _t(_ids(rng, 240, 2, n_vocab, "zipf"))
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    w = _t(rng.normal(size=(240, d)).astype(np.float32))
    grads = []
    for plan in (None, bag_grad_plan(idx, n_vocab)):
        t = _t(table).requires_grad_()
        b0 = bag_grad_plan.builds
        (BagSum.apply(t, idx, plan) * w).sum().backward()
        # without a plan the backward builds its own
        assert bag_grad_plan.builds == b0 + (plan is None)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])


def test_plan_of_other_ids_raises():
    idx = _t(np.zeros((10, 2), np.int32))
    g = torch.ones((10, 3))
    plan = bag_grad_plan(idx, 7)
    with pytest.raises(ValueError):
        embedding_bag_backward_ref(g, idx, 8, plan)           # another V
    with pytest.raises(ValueError):
        embedding_bag_backward_ref(g[:5], idx[:5], 7, plan)   # other ids
    with pytest.raises(ValueError):
        bag_grad_plan(idx.reshape(-1), 7)                     # not 2-D


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def carried(request):
    """(ref cfg, port cfg, ref params, port params, ids, labels)."""
    jc, tc = CONFIGS[request.param]
    jp = jd.init_deepfm(jax.random.PRNGKey(0), jc)
    tp = deepfm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _, idx, labels = next(j_stream(jc.vocab_per_field, 29, jc.multi_hot,
                                   seed=2))
    idx[1, 2, 0] = idx[4, 0, -1] = -1                # empty bag slots
    return jc, tc, jp, tp, idx, labels


def test_deepfm_gradients_over_the_shared_plan_match_reference(carried):
    jc, tc, jp, tp, idx, labels = carried
    want_loss, want = jax.value_and_grad(lambda p: jd.deepfm_loss(
        jc, p, jnp.asarray(idx), jnp.asarray(labels)))(jp)
    b0 = bag_grad_plan.builds
    loss, grads = tcfg.loss_and_grads(tc, tp, _t(idx), _t(labels))
    assert bag_grad_plan.builds == b0 + 1            # one plan, two tables
    np.testing.assert_allclose(loss.item(), float(want_loss), **MODEL_TOL)
    for g, w in zip(leaves(grads), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def test_deepfm_forward_with_grad_builds_one_plan(carried):
    _, tc, _, tp, idx, labels = carried
    model = td.DeepFM(tc, params=tp, device="cpu")
    b0 = bag_grad_plan.builds
    loss = td.deepfm_loss(tc, model.params(), _t(idx), _t(labels))
    assert bag_grad_plan.builds == b0 + 1
    loss.backward()                                  # the backward: none
    assert bag_grad_plan.builds == b0 + 1
    assert model.table.grad is not None and model.first_order.grad is not None


def test_deepfm_forward_under_no_grad_builds_no_plan(carried):
    _, tc, _, tp, idx, _ = carried
    model = td.DeepFM(tc, params=tp, device="cpu")
    b0 = bag_grad_plan.builds
    with torch.no_grad():
        model(_t(idx))
    td.deepfm_forward(tc, tp, _t(idx))               # no parameter needs grad
    assert bag_grad_plan.builds == b0


@pytest.mark.parametrize("n_slots,n_vocab,d", [
    (5_111_808, 3_729_408, 10), (5_111_808, 3_729_408, 1), (21, 4, 33),
    (1, 1, 16), (257, 10, 3), (100, 1000, 4096)])
def test_bag_grad_layout(n_slots, n_vocab, d):
    """Chunks of 256 slots; tiles of the least power of two of rows that
    holds 4096 floats, from 32 to 1024 rows; scratch: two partial rows a
    chunk, then a bit a row in 32-bit words at a 16-byte boundary."""
    chunk, tile_log2, scratch = bag_grad_layout(n_slots, n_vocab, d)
    rows = 1 << tile_log2
    assert chunk == 256 and 32 <= rows <= 1024
    assert rows * d >= 4096 or rows == 1024
    assert rows == 32 or rows // 2 * d < 4096
    words_at = scratch - 4 * -(-n_vocab // 32)
    n_chunks = -(-n_slots // 256)
    assert words_at % 16 == 0 and 0 <= words_at - 8 * d * n_chunks < 16


@pytest.mark.parametrize("d", [1, 10, 75])
@pytest.mark.parametrize("kind", ["zipf", "uniform", "invalid"])
def test_accumulate_plain_version_is_acc_plus_the_sums(d, kind):
    """``embedding_bag_backward_ref(..., acc=acc)`` is ``acc + the sums``
    bit for bit, in place; the CPU wrapper's accumulate form is the same.
    ``zipf`` puts about half the slots on id 0 (a run far longer than the
    wide path's 32-slot blocks) and sentinels in every fifth slot; with
    200 rows many stay untouched, and keep ``acc``'s bits."""
    rng = np.random.default_rng(40 + d)
    n_vocab = 200
    idx = _t(_ids(rng, 333, 3, n_vocab, kind))
    g = _t(rng.normal(size=(333, d)).astype(np.float32))
    acc0 = _t(rng.normal(size=(n_vocab, d)).astype(np.float32))
    plan = bag_grad_plan(idx, n_vocab)
    sums = embedding_bag_backward_ref(g, idx, n_vocab, plan)
    if kind == "zipf":
        assert int((plan.sorted_ids == 0).sum()) > 32      # a hub run
    acc = acc0.clone()
    got = embedding_bag_backward_ref(g, idx, n_vocab, plan, acc=acc)
    assert got is acc and torch.equal(got, acc0 + sums)
    untouched = (sums == 0).all(1)
    assert untouched.any() or kind == "uniform"
    assert torch.equal(got[untouched], acc0[untouched])
    acc = acc0.clone()
    assert embedding_bag_backward(g, idx, n_vocab, plan, acc=acc) is acc
    assert torch.equal(acc, acc0 + sums)
    with pytest.raises(ValueError):           # acc and _out exclude
        embedding_bag_backward(g, idx, n_vocab, plan, acc=acc,
                               _out=torch.empty_like(acc))


def test_scatter_add_is_scatter_sum_then_add_bitwise():
    """``ScatterAdd`` (the accumulate form under autograd) against
    ``ScatterSum`` followed by ``add_``, over two chunks of messages into
    one running sum: the values and the gradients of both chunks'
    messages and of the first chunk's sum bit for bit; the gradient of
    each message is its row's (the bag gather)."""
    rng = np.random.default_rng(8)
    n, d, e = 50, 75, 400
    idx = _t(_ids(rng, e, 1, n, "zipf"))
    m = [_t(rng.normal(size=(e // 2, d)).astype(np.float32))
         for _ in range(2)]
    up = _t(rng.normal(size=(n, d)).astype(np.float32))
    plans = [bag_grad_plan(idx[:e // 2], n), bag_grad_plan(idx[e // 2:], n)]
    runs = []
    for accumulate in (True, False):
        leaves = [t.clone().requires_grad_() for t in m]
        agg = ScatterSum.apply(leaves[0], idx[:e // 2], n, plans[0])
        if accumulate:
            agg = ScatterAdd.apply(agg, leaves[1], idx[e // 2:], n, plans[1])
        else:
            agg = agg.add_(ScatterSum.apply(leaves[1], idx[e // 2:], n,
                                            plans[1]))
        (agg * up).sum().backward()
        runs.append((agg.detach(), *(t.grad for t in leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.equal(runs[0][2], embedding_bag_kernel(up, idx[e // 2:]))


@pytest.mark.parametrize("n_slots,n_vocab,d", [
    (65_536, 169_984, 6_272), (168_960, 169_984, 128), (168_960, 169_984, 75),
    (1, 1, 32), (97, 10, 33), (100, 1000, 4096)])
def test_bag_wide_layout(n_slots, n_vocab, d):
    """Blocks of 32 slots; zero tiles of the least power of two of rows
    that holds 4096 floats of a 512-float slab (of d floats where d is
    narrower), from 1 to 64 rows; scratch: two partial rows a block, then
    a bit a row in 32-bit words at a 16-byte boundary."""
    seg, tile_log2, scratch = bag_wide_layout(n_slots, n_vocab, d)
    rows, slab = 1 << tile_log2, min(d, 512)
    assert seg == 32 and 1 <= rows <= 64
    assert rows * slab >= 4096 or rows == 64
    assert rows == 1 or rows // 2 * slab < 4096
    words_at = scratch - 4 * -(-n_vocab // 32)
    n_blocks = -(-n_slots // 32)
    assert words_at % 16 == 0 and 0 <= words_at - 8 * d * n_blocks < 16
    if (n_slots, d) == (65_536, 6_272):       # Equiformer-v2's chunk
        assert rows == 8 and words_at == 2048 * 2 * 6272 * 4


def test_kernel_paths_of_the_bag_kernels():
    """A launch of the bag backward runs the two passes of one path; the
    gather one kernel of either path; the plan its key pass and sort."""
    from repro_torch.trace_solve import kernel_paths

    assert kernel_paths("embedding_bag_backward") == (
        ("bag_grad_chunks", "bag_grad_finish"),
        ("bag_rows_sums", "bag_rows_finish"))
    assert kernel_paths("embedding_bag") == (("bag_tiles_kernel",),
                                             ("bag_rows_gather",))
    assert kernel_paths("bag_grad_plan") == (("bag_grad_keys",
                                              "repro_bag_plan::"),)
    with pytest.raises(ValueError):
        kernel_paths("index_add_")


@pytest.mark.parametrize("name,group,port", [
    ("void (anonymous namespace)::bag_rows_gather<4, 4>(float const*)",
     "bag_forward", "embedding_bag"),
    ("void (anonymous namespace)::bag_rows_sums<4, 1, true>(RowArgs)",
     "bag_backward", "embedding_bag_backward"),
    ("void (anonymous namespace)::bag_rows_finish<1, 3, false>(RowArgs)",
     "bag_backward", "embedding_bag_backward"),
    ("void (anonymous namespace)::bag_grad_chunks<10, true, 2>(Args)",
     "bag_backward", "embedding_bag_backward"),
    ("void (anonymous namespace)::bag_grad_finish<1, true>(Args, long long)",
     "bag_backward", "embedding_bag_backward"),
    ("void (anonymous namespace)::bag_grad_keys(int const*, int, int)",
     "sort", "bag_grad_plan"),
    ("void repro_bag_plan::cub::DeviceRadixSortOnesweepKernel<Policy>()",
     "sort", "bag_grad_plan"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<Policy>()",
     "sort", None),
    ("void (anonymous namespace)::bag_tiles_kernel<2, 12>(float const*)",
     "bag_forward", "embedding_bag")])
def test_profiler_names_of_the_bag_kernels(name, group, port):
    """The trace groups and the port's kernel names see the backward's
    passes and its plan's key pass and sort; PyTorch's own sorts count as
    sorts but not as the port's kernel."""
    from repro_torch.trace_deepfm import train_groups
    from repro_torch.trace_solve import PORT_KERNELS

    assert train_groups([(name, 0.5)]) == {group: 0.5}
    assert {v for k, v in PORT_KERNELS.items() if k in name} == (
        {port} if port else set())
