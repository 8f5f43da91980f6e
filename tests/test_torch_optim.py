"""Port's optimizers vs the JAX package, on the CPU.

``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on the same
numpy parameters and gradient stream: the schedule at step 0, in warm-up,
mid-cosine, at the end and past it; ``adamw_init``'s layouts; five steps
in each moment layout (f32, bf16, int8) with the clip active and
inactive. ``repro_torch.optim.compress`` against ``repro.optim.compress``:
``quantize_int8``/``dequantize_int8`` bit for bit, half-way cases
included, and ``compressed_psum``/``ef_compress_grad`` over each axis of a
2×2 gloo world of four spawned processes against the sum of the
reference's per-rank quantisations.

Tolerances: the schedule rtol 1e-6 (``cos`` of two libraries may differ
in the last place); parameters and float32 moments rtol 1e-6 / atol
1e-7 (the same float32 arithmetic; the gradient norm's sum may add in
another order); bfloat16 moments within one bfloat16 step (2^-7
relative) of the reference's; int8 moments within one quantisation level
(their per-tensor scale) of the reference's; the compressed sums rtol
1e-6 / atol 1e-7 (two float32 products and a sum, possibly fused).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_helpers as H  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro.optim import compress as jc  # noqa: E402
from repro_torch.dist import run_world  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.optim import compress as tc  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
WORLD_TIMEOUT_S = 120.0


def _t(a):
    return torch.from_numpy(np.array(a))            # keeps 0-d arrays 0-d


def _params(rng):
    """A tree with a nested list and a scalar, as DeepFM's is."""
    return dict(table=rng.normal(size=(30, 4)).astype(np.float32),
                mlp=dict(w=[rng.normal(size=(8, 3)).astype(np.float32),
                            rng.normal(size=(3, 1)).astype(np.float32)],
                         b=[np.zeros(3, np.float32), np.zeros(1, np.float32)]),
                bias=np.float32(0.25))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return _t(np.asarray(tree))


def _cfgs(**kw):
    return ja.AdamWConfig(**kw), ta.AdamWConfig(**kw)


@pytest.mark.parametrize("step", [0, 1, 37, 100, 101, 5050, 9999, 10_000,
                                  12_345])
def test_schedule_matches_reference(step):
    jcfg, tcfg = _cfgs()
    want = ja.schedule(jcfg, jnp.asarray(step, jnp.int32))
    got = ta.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_schedule_shape_warmup_cosine_floor():
    _, tcfg = _cfgs(lr=1.0, warmup_steps=10, total_steps=110,
                    min_lr_frac=0.1)
    lr = [ta.schedule(tcfg, torch.tensor(s, dtype=torch.int32)).item()
          for s in (0, 5, 10, 60, 110, 200)]
    assert lr[0] == 0.0 and lr[1] == pytest.approx(0.5)
    assert lr[2] == pytest.approx(1.0) and lr[3] == pytest.approx(0.55)
    assert lr[4] == pytest.approx(0.1) and lr[5] == pytest.approx(0.1)


@pytest.mark.parametrize("moments_dtype", ["f32", "bf16", "int8"])
def test_adamw_init_layout_matches_reference(moments_dtype):
    jcfg, tcfg = _cfgs(moments_dtype=moments_dtype)
    p = _params(np.random.default_rng(0))
    want = ja.adamw_init(jax.tree.map(jnp.asarray, p), jcfg)
    got = ta.adamw_init(_to_torch(p), tcfg)
    w_leaves = jax.tree.leaves(want)
    g_leaves = leaves(got)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype) == f"torch.{w.dtype}"
        assert not g.any()
    with pytest.raises(ValueError, match="moments_dtype"):
        ta.adamw_init(_to_torch(p), ta.AdamWConfig(moments_dtype="fp8"))


def _run_both(moments_dtype, grad_scale, n_steps=5):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=1.0,
              moments_dtype=moments_dtype)
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(11)
    p = _params(rng)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    jo, to = ja.adamw_init(jp, jcfg), ta.adamw_init(tp, tcfg)
    norms = []
    for _ in range(n_steps):
        g = jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * grad_scale)
                         .astype(np.float32), p)
        jp, jo, jm = ja.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                     jo)
        tp, to, tm = ta.adamw_update(tcfg, tp, _to_torch(g), to)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        norms.append(float(jm["grad_norm"]))
    return jp, jo, tp, to, norms


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no_clip", "clip"])
@pytest.mark.parametrize("moments_dtype", ["f32", "bf16", "int8"])
def test_adamw_five_steps_match_reference(moments_dtype, grad_scale):
    jp, jo, tp, to, norms = _run_both(moments_dtype, grad_scale)
    # the clip: active (norm above clip_norm 1.0) or not, as asked
    assert all((n > 1.0) == (grad_scale > 1) for n in norms)
    assert to["step"].dtype == torch.int32 and to["step"].item() == 5
    for g, w in zip(leaves(tp), jax.tree.leaves(jp)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for key in ("mu", "nu"):
        if moments_dtype == "int8":
            is_q = lambda x: isinstance(x, dict) and "q" in x  # noqa: E731
            for m_t, m_j in zip(_q8_leaves(to[key]),
                                jax.tree.leaves(jo[key], is_leaf=is_q)):
                level = float(m_j["scale"])
                assert m_t["q"].dtype == torch.int8
                got = m_t["q"].float().numpy() * m_t["scale"].item()
                want = np.asarray(m_j["q"], np.float32) * level
                assert np.abs(got - want).max() <= level * (1 + 1e-6)
        else:
            for g, w in zip(leaves(to[key]), jax.tree.leaves(jo[key])):
                want = np.asarray(w, np.float32)
                got = g.float().numpy()
                if moments_dtype == "bf16":
                    assert g.dtype == torch.bfloat16
                    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                               atol=1e-30)
                else:
                    np.testing.assert_allclose(got, want, **TOL)


def _q8_leaves(tree):
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [tree]
    if isinstance(tree, dict):
        return [m for k in sorted(tree) for m in _q8_leaves(tree[k])]
    return [m for sub in tree for m in _q8_leaves(sub)]


def test_adamw_leaves_its_arguments_alone():
    _, tcfg = _cfgs(lr=1e-2, warmup_steps=1)
    p = _to_torch(_params(np.random.default_rng(2)))
    g = {k: v for k, v in p.items()}
    before = [t.clone() for t in leaves(p)]
    state = ta.adamw_init(p, tcfg)
    new_p, new_state, _ = ta.adamw_update(tcfg, p, g, state)
    assert all(torch.equal(a, b) for a, b in zip(leaves(p), before))
    assert state["step"].item() == 0 and new_state["step"].item() == 1
    assert not torch.equal(new_p["table"], p["table"])


# -- compress -------------------------------------------------------------

def _halfway():
    """Values whose x / scale is exactly k + 0.5 (scale 1.0 from the 127):
    ``round`` must give the even neighbour, as ``jnp.round`` does."""
    return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0,
                     3.25, 0.0], np.float32)


@pytest.mark.parametrize("case", ["halfway", "normal", "zeros", "tiny"])
def test_quantize_int8_bitwise(case):
    rng = np.random.default_rng(5)
    x = {"halfway": _halfway(),
         "normal": rng.normal(size=(64, 7)).astype(np.float32),
         "zeros": np.zeros(9, np.float32),
         "tiny": np.full(4, 1e-14, np.float32)}[case]
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(tc.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))
    if case == "halfway":
        np.testing.assert_array_equal(tq.numpy()[:8],
                                      [127, 0, 2, 2, 0, -2, -2, 126])


@pytest.fixture(scope="module")
def world_results():
    return run_world(H.compress_body, 4, (H.COMPRESS_SEED,),
                     timeout=WORLD_TIMEOUT_S, threads=1)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_compressed_psum_over_each_axis_of_a_2x2_world(world_results, axis):
    """Each rank's compressed sum over ``axis`` equals the sum, in axis
    order, of the reference's dequantised values of the ranks of its
    line; ``ef_compress_grad`` gives that sum over the line's size and
    the reference's residual."""
    xs, gs, rs = H.compress_inputs(H.COMPRESS_SEED, 4)
    a = ("data", "model").index(axis)
    for rank, res in enumerate(world_results):
        coords = np.unravel_index(rank, (2, 2))
        line = [int(np.ravel_multi_index(
            tuple(k if i == a else c for i, c in enumerate(coords)), (2, 2)))
            for k in range(2)]
        deq = [np.asarray(jc.dequantize_int8(*jc.quantize_int8(
            jnp.asarray(xs[r])))) for r in line]
        np.testing.assert_allclose(res[axis]["psum"], deq[0] + deq[1], **TOL)
        corrected = [jnp.asarray(gs[r] + rs[r]) for r in line]
        sent = [np.asarray(jc.dequantize_int8(*jc.quantize_int8(c)))
                for c in corrected]
        np.testing.assert_allclose(res[axis]["ef"], (sent[0] + sent[1]) / 2,
                                   **TOL)
        mine = line.index(rank)
        np.testing.assert_allclose(
            res[axis]["residual"], np.asarray(corrected[mine]) - sent[mine],
            **TOL)
        assert res[axis]["calls"] == 4                # q and scale, twice
