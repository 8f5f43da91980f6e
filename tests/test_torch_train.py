"""Port's DeepFM training path vs the JAX package, on the CPU.

The same numpy inputs go through both packages:

* the bag gradient: the port's autograd gradient of ``(embedding_bag(
  table, ids) * w).sum()`` (through ``BagSum`` and the plain backward)
  against ``jax.grad`` through ``repro.models.recsys.embedding.
  embedding_bag``, at d = 4 and d = 1, with sentinel ids (−2, −1, V,
  V + 3), duplicates within and across bags and Zipf skew; and the plain
  backward against a numpy scatter;
* ``deepfm_loss`` and the gradient of every parameter on ``SMOKE`` and a
  narrow 39-field config, from the reference's parameters carried over by
  ``deepfm_params_from_numpy``;
* three steps of the train step (``configs.deepfm.make_train_step``) on
  ``SMOKE`` from the reference's parameters and optimizer state (carried
  over by ``adamw_state_from_numpy``), in each moment layout;
* the runner: the reference's ``TestRunner`` cases on the port (recovery
  bitwise equal to a clean run), a DeepFM ``SMOKE`` run with injected
  failures, and a step that always fails (ROADMAP C8).

Tolerances: bag gradients rtol / atol 1e-6 (the same float32 adds, in
slot order in both); the plain backward bitwise equal to a float32 numpy
loop over the slots in order; the loss and gradients rtol / atol 1e-5 (the float32
matrix products sum in another order); train-step losses rtol 1e-5 and
parameters atol 1e-6 with f32 and bf16 moments (Adam's normalisation
takes float32 noise of a near-zero gradient to at most one lr-sized step,
so the parameters are held where the reference's and the port's
gradients agree: see ``test_train_step_matches_reference``); int8
moments, whose per-tensor quantisation can move a value by one level
from such noise, within one quantisation level of the reference's.
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
from repro.models.recsys import embedding as je  # noqa: E402
from repro.optim import adamw as ja  # noqa: E402
from repro_torch.configs import deepfm as tcfg  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 deepfm_params_from_numpy)
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_backward, embedding_bag_backward_ref)
from repro_torch.models.recsys import deepfm as td  # noqa: E402
from repro_torch.models.recsys import embedding as te  # noqa: E402
from repro_torch.optim import adamw as ta  # noqa: E402
from repro_torch.runtime import FailureInjector, TrainLoopRunner  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

BAG_TOL = dict(rtol=1e-6, atol=1e-6)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
NARROW39 = dict(n_fields=39, embed_dim=10, mlp_sizes=(32, 32),
                vocab_per_field=jd.default_vocabs(39, scale=1e-3),
                multi_hot=2)
CONFIGS = {"smoke": (jcfg.SMOKE, tcfg.SMOKE),
           "narrow39": (jd.DeepFMConfig(**NARROW39),
                        td.DeepFMConfig(**NARROW39))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _zipf_bags(rng, n_bags, hot, n_vocab):
    """Zipf-like ids (id 0 takes about half), duplicates within bags, and
    every fifth slot a sentinel: −2, −1, V or V + 3."""
    u = rng.random((n_bags, hot))
    idx = np.minimum(u ** -1.1, n_vocab).astype(np.int64) - 1
    idx = np.clip(idx, 0, n_vocab - 1).astype(np.int32)
    idx[::3, -1] = idx[::3, 0]                       # a duplicate in a bag
    flat = idx.reshape(-1)
    flat[::5] = np.resize(np.array([-2, -1, n_vocab, n_vocab + 3], np.int32),
                          flat[::5].shape)
    return idx


def _scatter(g_out, idx, n_vocab):
    """The table's gradient by a float32 loop over the slots in order."""
    want = np.zeros((n_vocab, g_out.shape[1]), np.float32)
    for b, h in np.ndindex(*idx.shape):
        if 0 <= idx[b, h] < n_vocab:
            want[idx[b, h]] += g_out[b]
    return want


@pytest.mark.parametrize("d", [4, 1])
def test_bag_gradient_matches_jax_grad(d):
    rng = np.random.default_rng(d)
    n_vocab = 40
    table = rng.normal(size=(n_vocab, d)).astype(np.float32)
    idx = _zipf_bags(rng, 300, 3, n_vocab).reshape(30, 10, 3)
    w = rng.normal(size=(30, 10, d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(je.embedding_bag(
        t, jnp.asarray(idx)) * w))(jnp.asarray(table))
    t = _t(table).requires_grad_()
    n0 = embedding_bag_backward.launches
    (te.embedding_bag(t, _t(idx)) * _t(w)).sum().backward()
    assert embedding_bag_backward.launches == n0     # the CPU: plain version
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **BAG_TOL)
    touched = np.zeros(n_vocab, bool)
    ok = idx[(idx >= 0) & (idx < n_vocab)]
    touched[ok] = True
    assert not t.grad.numpy()[~touched].any()        # untouched rows: 0


def test_bag_gradient_of_a_stride_zero_output_gradient():
    """The first-order term's gradient reaches ``BagSum`` as an expand."""
    rng = np.random.default_rng(7)
    idx = _zipf_bags(rng, 64, 2, 25).reshape(16, 4, 2)
    w1 = _t(rng.normal(size=(25, 1)).astype(np.float32)).requires_grad_()
    coef = _t(rng.normal(size=16).astype(np.float32))
    (te.embedding_bag(w1, _t(idx)).sum(dim=(1, 2)) * coef).sum().backward()
    want = _scatter(np.repeat(coef.numpy(), 4)[:, None],
                    idx.reshape(-1, 2), 25)
    np.testing.assert_allclose(w1.grad.numpy(), want, **BAG_TOL)


@pytest.mark.parametrize("n_bags,hot,d", [(300, 3, 4), (513, 2, 1),
                                          (1, 1, 10), (0, 2, 3)])
def test_plain_backward_matches_numpy_scatter(n_bags, hot, d):
    rng = np.random.default_rng(n_bags)
    n_vocab = 37
    idx = _zipf_bags(rng, n_bags, hot, n_vocab)
    g = rng.normal(size=(n_bags, d)).astype(np.float32)
    got = embedding_bag_backward_ref(_t(g), _t(idx), n_vocab)
    assert got.shape == (n_vocab, d) and got.dtype == torch.float32
    # each row's float32 sum in slot order, as the loop's: bit for bit
    np.testing.assert_array_equal(got.numpy(), _scatter(g, idx, n_vocab))
    # the CPU wrapper is the plain version, bit for bit
    assert torch.equal(embedding_bag_backward(_t(g), _t(idx), n_vocab), got)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def carried(request):
    """(ref cfg, port cfg, ref params, port params, ids, labels)."""
    jc, tc = CONFIGS[request.param]
    jp = jd.init_deepfm(jax.random.PRNGKey(0), jc)
    tp = deepfm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _, idx, labels = next(j_stream(jc.vocab_per_field, 37, jc.multi_hot,
                                   seed=1))
    idx[0, 1, 1] = idx[3, 0, 0] = -1                 # empty bag slots
    return jc, tc, jp, tp, idx, labels


def test_deepfm_loss_and_gradients_match_reference(carried):
    jc, tc, jp, tp, idx, labels = carried
    want_loss, want = jax.value_and_grad(lambda p: jd.deepfm_loss(
        jc, p, jnp.asarray(idx), jnp.asarray(labels)))(jp)
    loss, grads = tcfg.loss_and_grads(tc, tp, _t(idx), _t(labels))
    np.testing.assert_allclose(loss.item(), float(want_loss), **MODEL_TOL)
    got_leaves, want_leaves = leaves(grads), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == 2 * len(tp["mlp"]["w"]) + 3
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)
    # the parameters stay as they were: no grad, no graph
    assert not any(p.requires_grad for p in leaves(tp))


def test_deepfm_module_trains_through_the_loss(carried):
    _, tc, _, tp, idx, labels = carried
    model = td.DeepFM(tc, params=tp, device="cpu")
    td.deepfm_loss(tc, model.params(), _t(idx), _t(labels)).backward()
    _, grads = tcfg.loss_and_grads(tc, tp, _t(idx), _t(labels))
    for p, g in zip(leaves(model.params()), leaves(grads)):
        assert torch.equal(p.grad, g)
    with torch.no_grad():
        assert model(_t(idx)).grad_fn is None        # serving: no graph


def _opt_cfgs(moments_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moments_dtype=moments_dtype)
    return ja.AdamWConfig(**kw), ta.AdamWConfig(**kw)


@pytest.mark.parametrize("moments_dtype", ["f32", "bf16", "int8"])
def test_train_step_matches_reference(moments_dtype):
    """Three steps of ``SMOKE`` from the reference's parameters and state.

    Step by step the port's losses, gradient norms and learning rates
    agree with the reference's; then the port's AdamW fed the reference's
    own gradients reproduces the reference's parameters to 1e-6, which
    shows the remaining parameter gaps are gradient noise through Adam's
    normalisation, not the optimizer."""
    jc, tc = jcfg.SMOKE, tcfg.SMOKE
    joc, toc = _opt_cfgs(moments_dtype)
    jp = jd.init_deepfm(jax.random.PRNGKey(0), jc)
    jo = ja.adamw_init(jp, joc)
    tp = deepfm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    to = adamw_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    step = tcfg.make_train_step(tc, toc)
    fed_p, fed_o = tp, to                    # the port's AdamW, ref grads
    for s in range(3):
        _, idx, lab = next(j_stream(jc.vocab_per_field, 37, 2, seed=1,
                                    start_step=s))
        loss, grads = jax.value_and_grad(lambda p: jd.deepfm_loss(
            jc, p, jnp.asarray(idx), jnp.asarray(lab)))(jp)
        jp, jo, jm = ja.adamw_update(joc, jp, grads, jo)
        tp, to, tm = step(tp, to, _t(idx), _t(lab))
        np.testing.assert_allclose(tm["loss"].item(), float(loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        assert to["step"].dtype == torch.int32 and to["step"].item() == s + 1
        g = deepfm_params_from_numpy(jax.tree.map(np.asarray, grads), "cpu")
        fed_p, fed_o, _ = ta.adamw_update(toc, fed_p, g, fed_o)
    for a, b in zip(leaves(fed_p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    if moments_dtype == "int8":
        # the moments from the port's own gradients: within one level
        for key in ("mu", "nu"):
            for m_t, m_j in zip(_int8_moments(to[key]),
                                _int8_moments(jo[key])):
                level = float(np.asarray(m_j["scale"]))
                got = m_t["q"].float().numpy() * m_t["scale"].item()
                want = np.asarray(m_j["q"], np.float32) * level
                assert np.abs(got - want).max() <= level * (1 + 1e-4)
    else:
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def _int8_moments(tree):
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [tree]
    if isinstance(tree, dict):
        return [m for k in sorted(tree) for m in _int8_moments(tree[k])]
    return [m for sub in tree for m in _int8_moments(sub)]


# -- the runner: the reference's TestRunner cases on the port -------------

def _toy():
    """The reference's toy quadratic: params converge to the data mean."""
    def step_fn(params, opt, batch):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.mean((w - batch) ** 2), w)
        w = params["w"] - 0.1 * g
        return dict(w=w), opt, dict(loss=torch.mean((w - batch) ** 2),
                                    grad_norm=torch.linalg.norm(g))

    def data_fn(step):
        rng = np.random.default_rng(step)   # deterministic replay
        return _t(rng.normal(size=(4,)).astype(np.float32) + 3.0)

    return step_fn, data_fn


def test_runner_runs_and_checkpoints(tmp_path):
    from repro_torch.checkpoint import latest_step

    step_fn, data_fn = _toy()
    runner = TrainLoopRunner(step_fn, data_fn, str(tmp_path), ckpt_every=5)
    params, _, metrics = runner.run(dict(w=torch.zeros(4)), {}, 60)
    assert latest_step(str(tmp_path)) == 60
    assert float(metrics["loss"]) < 2.0


def test_runner_recovers_bitwise(tmp_path):
    step_fn, data_fn = _toy()
    inj = FailureInjector(fail_at=(7, 13))
    runner = TrainLoopRunner(step_fn, data_fn, str(tmp_path / "a"),
                             ckpt_every=5, failure_injector=inj)
    params, _, _ = runner.run(dict(w=torch.zeros(4)), {}, 20)
    assert inj.fired == {7, 13} and runner.max_retries == 1
    clean = TrainLoopRunner(step_fn, data_fn, str(tmp_path / "b"),
                            ckpt_every=5)
    params2, _, _ = clean.run(dict(w=torch.zeros(4)), {}, 20)
    assert torch.equal(params["w"], params2["w"])


def test_runner_raises_a_step_that_always_fails(tmp_path):
    """C8: every recovery counts against ``max_retries``; then the step's
    own error comes out (the reference would restore and retry forever)."""
    step_fn, data_fn = _toy()
    calls = []

    def broken(params, opt, batch):
        calls.append(1)
        if len(calls) > 3:
            raise ValueError("kernel failed to launch")
        return step_fn(params, opt, batch)

    runner = TrainLoopRunner(broken, data_fn, str(tmp_path), ckpt_every=2,
                             max_retries=2)
    with pytest.raises(ValueError, match="failed to launch"):
        runner.run(dict(w=torch.zeros(4)), {}, 10)
    assert len(calls) == 3 + 3 and runner.max_retries == 0


def test_deepfm_smoke_run_recovers_bitwise(tmp_path):
    """``SMOKE`` through the runner with two injected failures equals an
    uninterrupted run bit for bit: params, moments and step."""
    cfg = tcfg.SMOKE
    step = tcfg.make_train_step(cfg, ta.AdamWConfig(lr=1e-2, warmup_steps=2,
                                                    total_steps=12))

    def data_fn(s):
        _, idx, lab = next(j_stream(cfg.vocab_per_field, 64, 2, seed=0,
                                    start_step=s))
        return _t(idx), _t(lab)

    def run(path, injector):
        p = td.init_deepfm(cfg, torch.Generator().manual_seed(0), "cpu")
        runner = TrainLoopRunner(lambda p, o, b: step(p, o, *b), data_fn,
                                 str(path), ckpt_every=4,
                                 failure_injector=injector)
        return runner.run(p, ta.adamw_init(p), 12)

    inj = FailureInjector((5, 9))
    pa, oa, ma = run(tmp_path / "a", inj)
    pb, ob, mb = run(tmp_path / "b", None)
    assert inj.fired == {5, 9}
    for a, b in zip(leaves((pa, oa)), leaves((pb, ob))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(ma["loss"], mb["loss"])
