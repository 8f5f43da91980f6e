"""The port's MoE LMs (``repro_torch.models.transformer.moe_ffn`` and the
two MoE configs, arctic-480b and moonshot-v1-16b-a3b) vs the JAX package,
on the CPU.

Weights are numpy draws from a seed (N(0, 0.02²) matrices, norms 1 ±
0.1) at each MoE config's ``SMOKE`` (float32), passed to the reference as
they are and to the port through ``convert.lm_params_from_numpy``.
Tolerances (each element within rtol of the reference's value, plus, where
no atol is given, rtol times the output's largest |x|):

* the routing, ``(idx, pos, keep)`` of ``moe_route`` against the
  reference's own steps (``jax.lax.top_k``, the one-hot ``cumsum``, the
  capacity rule) on the same inputs: bit for bit, on three seeds; in
  bfloat16 on inputs and a router that are small integers times powers of
  two (every product and partial sum exact in both packages, so the case
  tests the rule, not a product's rounding), with a tie at the top-k
  boundary asserted present; with a zero router (every token ties, so
  experts 0 … k−1 win and entries past ``cap`` drop); with a router that
  sends most tokens to one expert; and with ``moe_token_shards`` 2;
* ``moe_ffn`` forward: rtol 1e-5; its gradients in ``x`` and in every MoE
  leaf: rtol 1e-5, atol 1e-7 (one and two token shards); and no float
  atomic in its forward or backward: no ``index_add``, ``scatter_add``,
  ``scatter_reduce`` or accumulating ``index_put`` on a float tensor, and
  no ``topk``, among the operators it dispatches;
* ``forward`` and ``lm_loss``: rtol 1e-5, and the loss's gradients in
  every leaf at rtol 1e-5 / atol 1e-7 (the loss with and without a graph
  bit for bit); ``decode_step`` at ``cache_len`` 0
  and 5: rtol 1e-5, the caches written in place;
* ``lm_train_step`` at 1 and 2 microbatches, AdamW at eps 1e-5 (the dense
  test's eps, ROADMAP C12), two steps: parameters and first moments at
  rtol 1e-5 / atol 1e-7, second moments at atol 1e-9, loss and gradient
  norm at rtol 1e-5; except that a parameter entry whose Adam denominator
  ``sqrt(v̂)`` has fallen below eps (about 5 % of them in float32 here:
  experts that few tokens reached, rare tokens' rows; more with int8
  moments, which round small ones to 0) is held at atol 1e-5, the
  gradients' 1e-7 times lr/eps, the most by which Adam magnifies the
  rounding of such a near-zero gradient (C12; the largest gap measured
  on the CPU is 6.8e-7, in a row of ``lm_head``); a step with
  ``donate=True`` gives the functional step's bits, written into the
  given trees;
* arctic's int8 AdamW state from the reference (``adamw_state_from_numpy``)
  bit for bit, and one more update from it in both packages, its
  parameters held as above;
* in the port alone, decoding a sequence token by token from an empty
  cache gives ``forward``'s logits within 1e-5 of their largest |x|, with
  ``capacity_factor`` E/k: the forward routes 60 tokens a shard and a
  decode step 3, so at the default factor the two drop different entries
  (an entry's queue depends on the tokens routed beside it); at E/k the
  capacity is every token, and nothing drops in either.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the tensors here are small, and a pool in each
# test process oversubscribes the cores when test files run in parallel
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.configs.arctic_480b as j_arctic  # noqa: E402
import repro.configs.lm_common as JL  # noqa: E402
import repro.configs.moonshot_v1_16b_a3b as j_moon  # noqa: E402
import repro.models.sharding as JS  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
import repro.optim.adamw as JA  # noqa: E402
import repro_torch.configs.arctic_480b as t_arctic  # noqa: E402
import repro_torch.configs.lm_common as TL  # noqa: E402
import repro_torch.configs.moonshot_v1_16b_a3b as t_moon  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
import repro_torch.optim.adamw as TA  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.models.sharding import ShardingPlan, null_plan  # noqa: E402
from repro_torch.tree import leaves, value_and_grad  # noqa: E402

MOE = {"arctic-480b": (j_arctic, t_arctic),
       "moonshot-v1-16b-a3b": (j_moon, t_moon)}
MOE_LEAVES = ("router", "moe_gate", "moe_up", "moe_down")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6, eps=1e-5)
# a parameter entry whose Adam denominator sqrt(v̂) falls below eps moves
# by lr·m̂/eps: a rounding of its near-zero gradient is magnified by up to
# lr/eps (ROADMAP C12), so it is held at the gradients' atol times that
GRAD_ATOL = 1e-7
ILL_ATOL = OPT["lr"] / OPT["eps"] * GRAD_ATOL


def close(got, want, rtol, atol=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if atol is None:
        atol = rtol * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def numpy_weights(cfg, seed=0) -> dict:
    """The reference's parameter tree for ``cfg`` (its keys and shapes),
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: JT.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    out = {}
    for k in sorted(shapes):
        shape = shapes[k].shape
        scale = 0.1 if k.endswith("norm") else 0.02
        out[k] = (float(k.endswith("norm")) + scale * rng.normal(
            size=shape)).astype(np.float32)
    return out


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def port_moe(m) -> TT.MoEConfig:
    return TT.MoEConfig(**dataclasses.asdict(m))


@pytest.fixture(scope="module", params=sorted(MOE))
def model(request):
    jm, tm = MOE[request.param]
    w = numpy_weights(jm.SMOKE)
    return dict(jcfg=jm.SMOKE, tcfg=tm.SMOKE, w=w,
                jp={k: jnp.asarray(v) for k, v in w.items()},
                tp=lm_params_from_numpy(w, "cpu"),
                toks=tokens(jm.SMOKE, (2, 33)))


# ---------------------------------------------------------------------------
# the routing
# ---------------------------------------------------------------------------

def reference_route(xt, router, m):
    """``(idx, pos, keep)`` by the reference's steps
    (``src/repro/models/transformer.py`` ``moe_ffn``) on ``xt``
    [shards, Tl, d]."""
    s, Tl, _ = xt.shape
    logits = jnp.einsum("std,de->ste", xt, router.astype(xt.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    cap = max(int(m.capacity_factor * Tl * m.top_k / m.n_experts),
              m.top_k, 1)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(s, Tl * m.top_k, m.n_experts)
    pos = jnp.cumsum(flat, axis=1) * flat - 1
    pos = pos.max(axis=-1).reshape(s, Tl, m.top_k)
    keep = (pos < cap) & (pos >= 0)
    return np.asarray(idx), np.asarray(pos), np.asarray(keep), cap


def route_both(x, router, m, shards=1, dtype=np.float32):
    """The port's and the reference's routing of ``x`` [T, d] split in
    ``shards``; asserts they are equal bit for bit; returns the port's."""
    T, d = x.shape
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xt = x.reshape(shards, T // shards, d)
    r = TT.moe_route(torch.tensor(xt).to(tdt), torch.tensor(router).to(tdt),
                     port_moe(m))
    idx, pos, keep, cap = reference_route(jnp.asarray(xt, jdt),
                                          jnp.asarray(router, jdt), m)
    assert r.cap == cap
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("jm", [j_arctic, j_moon], ids=lambda m: m.SMOKE.name)
def test_routing_is_bitwise_the_reference(jm, seed):
    rng = np.random.default_rng(seed)
    # capacity at the mean load, so that entries drop on every seed
    m = dataclasses.replace(jm.SMOKE.moe, capacity_factor=1.0)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    router = rng.normal(size=(32, m.n_experts)).astype(np.float32)
    r = route_both(x, router, m)
    assert not r.keep.all()                          # some entries drop


def test_routing_ties_in_bfloat16():
    """Small integers times powers of two: every logit is a multiple of
    1/4 below 4 in magnitude, exact in bfloat16 at every partial sum, so
    equal logits tie exactly in both packages."""
    rng = np.random.default_rng(3)
    m = j_moon.SMOKE.moe
    x = rng.integers(-2, 3, (64, 32)).astype(np.float32)
    router = np.zeros((32, m.n_experts), np.float32)
    for e in range(m.n_experts):                     # 2 nonzeros a column
        rows = rng.choice(32, 2, replace=False)
        router[rows, e] = rng.integers(-1, 2, 2) * 0.25
    r = route_both(x, router, m, dtype="bfloat16")
    p = torch.sort(r.probs, dim=-1, descending=True).values
    assert (p[..., m.top_k - 1] == p[..., m.top_k]).any()   # a boundary tie
    assert (p[..., 0] == p[..., 1]).any()                   # a tie inside


def test_routing_zero_router_ties_everywhere():
    m = j_moon.SMOKE.moe
    x = np.random.default_rng(4).normal(size=(40, 16)).astype(np.float32)
    r = route_both(x, np.zeros((16, m.n_experts), np.float32), m)
    assert (r.idx == torch.arange(m.top_k)).all()    # experts 0 … k−1
    cap = r.cap
    assert cap < 40
    want = torch.arange(40)[:, None].expand(40, m.top_k)
    assert torch.equal(r.pos[0], want)
    assert torch.equal(r.keep[0], want < cap)


def test_routing_overflow_to_one_expert():
    rng = np.random.default_rng(5)
    m = j_arctic.SMOKE.moe
    x = rng.normal(size=(64, 32)).astype(np.float32)
    x[:, 0] = 3.0
    router = 0.1 * rng.normal(size=(32, m.n_experts)).astype(np.float32)
    router[0, 5] = 4.0
    r = route_both(x, router, m)
    assert int((r.idx[..., 0] == 5).sum()) > 2 * r.cap
    assert int((~r.keep).sum()) >= int((r.idx[..., 0] == 5).sum()) - r.cap


def test_routing_two_token_shards():
    rng = np.random.default_rng(6)
    m = j_moon.SMOKE.moe
    x = rng.normal(size=(64, 32)).astype(np.float32)
    router = rng.normal(size=(32, m.n_experts)).astype(np.float32)
    r = route_both(x, router, m, shards=2)
    assert r.pos.shape == (2, 32, m.top_k)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

def moe_case(jm, seed=7):
    """``moe_ffn``'s inputs at the model's scales: weights N(0, 0.02²), a
    unit-normal ``x`` (RMSNorm's output) and upstream gradient."""
    rng = np.random.default_rng(seed)
    m, d = jm.SMOKE.moe, 64
    f, n = m.d_ff_expert, m.n_experts
    shapes = dict(router=(d, n), moe_gate=(n, d, f), moe_up=(n, d, f),
                  moe_down=(n, f, d))
    if m.n_shared:
        shapes.update(shared_gate=(d, m.n_shared * f),
                      shared_up=(d, m.n_shared * f),
                      shared_down=(m.n_shared * f, d))
    lw = {k: (0.02 * rng.normal(size=v)).astype(np.float32)
          for k, v in shapes.items()}
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    up = rng.normal(size=x.shape).astype(np.float32)
    return m, x, lw, up


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("jm", [j_arctic, j_moon], ids=lambda m: m.SMOKE.name)
def test_moe_ffn_and_gradients(jm, shards):
    m, x, lw, up = moe_case(jm)
    jplan = JS.ShardingPlan(None, {}, moe_token_shards=shards)

    def jfwd(x, lw):
        return JT.moe_ffn(x, lw, m, jplan)

    def both(x, lw):
        return jfwd(x, lw), jax.grad(lambda x, lw: jnp.sum(
            jfwd(x, lw) * up), argnums=(0, 1))(x, lw)

    jx, jlw = jnp.asarray(x), {k: jnp.asarray(v) for k, v in lw.items()}
    want, (jgx, jglw) = jax.jit(both)(jx, jlw)
    tx = torch.tensor(x, requires_grad=True)
    tlw = {k: torch.tensor(v, requires_grad=True) for k, v in lw.items()}
    got = TT.moe_ffn(tx, tlw, port_moe(m),
                     ShardingPlan(None, {}, moe_token_shards=shards))
    close(got.detach(), want, 1e-5)
    (got * torch.tensor(up)).sum().backward()
    close(tx.grad, jgx, 1e-5, 1e-7)
    for k in lw:
        close(tlw[k].grad, jglw[k], 1e-5, 1e-7)
        assert (tlw[k].grad != 0).any(), k


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        float_out = any(isinstance(a, torch.Tensor) and a.is_floating_point()
                        for a in args[:1])
        accumulate = bool(kwargs.get("accumulate", args[3] if len(args) > 3
                                     and "index_put" in name else False))
        self.seen.append((name, float_out, accumulate))
        return func(*args, **kwargs)


@pytest.mark.parametrize("jm", [j_arctic, j_moon], ids=lambda m: m.SMOKE.name)
def test_moe_ffn_has_no_float_atomics(jm):
    m, x, lw, up = moe_case(jm)
    tx = torch.tensor(x, requires_grad=True)
    tlw = {k: torch.tensor(v, requires_grad=True) for k, v in lw.items()}
    with _Ops() as ops:
        out = TT.moe_ffn(tx, tlw, port_moe(m), null_plan())
        (out * torch.tensor(up)).sum().backward()
    names = {n for n, _, _ in ops.seen}
    assert {"sort", "index_put_", "index_select"} <= {
        n.split(".")[0] for n in names}
    for name, is_float, accumulate in ops.seen:
        base = name.split(".")[0]
        assert "topk" not in base, name
        if is_float:
            assert base not in ("index_add", "index_add_", "scatter_add",
                                "scatter_add_", "scatter_reduce",
                                "scatter_reduce_", "_index_put_impl_"), name
            assert not accumulate, name


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def port_config(ref_cfg):
    """The port's TransformerConfig with every field of ``ref_cfg``."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["dtype"] = torch.bfloat16 if ref_cfg.dtype == jnp.bfloat16 \
        else torch.float32
    kw["moe"] = port_moe(ref_cfg.moe)
    return TT.TransformerConfig(**kw)


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_configs_are_the_reference_configs(name):
    jm, tm = MOE[name]
    for which in ("FULL", "SMOKE"):
        assert port_config(getattr(jm, which)) == getattr(tm, which)
    assert tm.FULL.param_count() == jm.FULL.param_count()


@pytest.mark.parametrize("name", sorted(MOE))
def test_init_params_layout(name):
    jm, tm = MOE[name]
    p = TT.init_params(tm.SMOKE, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jm.SMOKE),
                            jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in shapes.items()}
    assert {"router", "moe_gate", "moe_up", "moe_down"} <= set(p)
    assert ("w_gate" in p) == jm.SMOKE.moe.dense_residual
    assert ("shared_gate" in p) == bool(jm.SMOKE.moe.n_shared)
    assert all(k in TT._STACKED for k in p
               if k not in ("embed", "final_norm", "lm_head"))


def test_params_from_numpy_keep_the_moe_leaves(model):
    assert model["tp"].keys() == model["w"].keys()
    for k, v in model["w"].items():
        assert model["tp"][k].dtype == torch.float32
        np.testing.assert_array_equal(model["tp"][k].numpy(), v)
    assert set(MOE_LEAVES) <= set(model["tp"])


def test_forward(model):
    t = torch.tensor(model["toks"])
    with torch.no_grad():
        logits = TT.forward(model["tcfg"], model["tp"], t[:, :-1])
    jcfg = model["jcfg"]
    want = jax.jit(lambda p, t: JT.forward(jcfg, p, t))(
        model["jp"], jnp.asarray(model["toks"][:, :-1]))
    assert logits.shape == want.shape
    close(logits, want, 1e-5)


def test_loss_and_gradients(model):
    toks = model["toks"]
    loss, grads = value_and_grad(
        lambda p: TT.lm_loss(model["tcfg"], p, torch.tensor(toks)),
        model["tp"])
    with torch.no_grad():
        loss_nograd = TT.lm_loss(model["tcfg"], model["tp"],
                                 torch.tensor(toks))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(model["jcfg"], p, jnp.asarray(toks))))(
        model["jp"])
    close(loss, jloss, 1e-5)
    assert torch.equal(loss, loss_nograd)
    assert grads.keys() == jgrads.keys()
    for k in grads:
        close(grads[k], jgrads[k], 1e-5, atol=1e-7)
        assert (grads[k] != 0).any(), k


_JAX_DECODE = {}


def _jax_decode(cfg):
    """The reference's ``decode_step`` for ``cfg``, jitted once (the
    cache length traced, as the reference allows)."""
    if cfg.name not in _JAX_DECODE:
        _JAX_DECODE[cfg.name] = jax.jit(
            lambda p, t, c, n: JT.decode_step(cfg, p, t, c, n))
    return _JAX_DECODE[cfg.name]


@pytest.mark.parametrize("cache_len", [0, 5])
def test_decode_step(model, cache_len):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    B, T = 2, 12
    jcache = JT.init_kv_cache(jcfg, B, T)
    tcache = TT.init_kv_cache(tcfg, B, T, device="cpu")
    if cache_len:
        rng = np.random.default_rng(7)
        filled = [rng.normal(size=jcache[0].shape).astype(np.float32)
                  for _ in range(2)]
        for a in filled:
            a[:, :, cache_len:] = 0
        jcache = tuple(jnp.asarray(a) for a in filled)
        tcache = tuple(torch.tensor(a) for a in filled)
    tok = model["toks"][:, :1]
    with torch.no_grad():
        logits, new = TT.decode_step(tcfg, model["tp"], torch.tensor(tok),
                                     tcache, cache_len)
    jlogits, jnew = _jax_decode(jcfg)(model["jp"], jnp.asarray(tok), jcache,
                                      jnp.int32(cache_len))
    assert logits.shape == jlogits.shape == (B, 1, jcfg.vocab)
    close(logits, jlogits, 1e-5)
    for got, given, want in zip(new, tcache, jnew):
        assert got is given                        # written in place
        close(got, want, 1e-5)


def test_decode_token_by_token_matches_forward(model):
    m = model["tcfg"].moe
    cfg = dataclasses.replace(model["tcfg"], moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    p = model["tp"]
    t = torch.tensor(tokens(cfg, (3, 20), seed=2))
    with torch.no_grad():
        full = TT.forward(cfg, p, t)
        cache = TT.init_kv_cache(cfg, 3, 20, device="cpu")
        steps = []
        for i in range(20):
            logits, cache = TT.decode_step(cfg, p, t[:, i:i + 1], cache, i)
            steps.append(logits)
    close(torch.cat(steps, 1), full, 1e-5, atol=1e-5 * float(
        full.abs().max()))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def batch(cfg, step):
    return tokens(cfg, (4, 17), seed=10 + step)


def nu_hat(nu, step):
    """The reference's bias-corrected second moment after ``step`` steps
    (an int8 moment dequantised)."""
    if isinstance(nu, dict):
        nu = np.asarray(nu["q"], np.float32) * np.asarray(nu["scale"])
    return np.asarray(nu, np.float64) / (1 - JA.AdamWConfig().beta2 ** step)


def close_params(got, want, ill):
    """rtol 1e-5 and atol GRAD_ATOL, or ILL_ATOL where ``ill``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = np.where(ill, ILL_ATOL, GRAD_ATOL) + 1e-5 * np.abs(want)
    bad = np.abs(got - want) > bound
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_steps_match_the_reference(model, n_mb):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    step = jax.jit(JL.lm_train_step(jcfg, JS.null_plan(),
                                    JA.AdamWConfig(**OPT),
                                    n_microbatches=n_mb))
    jp, jopt = model["jp"], JA.adamw_init(model["jp"])
    tstep = TL.lm_train_step(tcfg, null_plan(), TA.AdamWConfig(**OPT),
                             n_microbatches=n_mb)
    params = lm_params_from_numpy(model["w"], "cpu")
    opt = TA.adamw_init(params)
    run = []
    for i in range(2):
        params, opt, m = tstep(params, opt, torch.tensor(batch(tcfg, i)))
        run.append((m, dict(p=params, mu=opt["mu"], nu=opt["nu"])))
    ill = {k: np.zeros(v.shape, bool) for k, v in model["w"].items()}
    for i, (m, got) in enumerate(run):
        jp, jopt, jm = step(jp, jopt, jnp.asarray(batch(tcfg, i)))
        close(m["loss"], jm["loss"], 1e-5, 0)
        close(m["grad_norm"], jm["grad_norm"], 1e-5, 0)
        for k in jp:
            vh = nu_hat(jopt["nu"][k], i + 1)
            ill[k] |= np.sqrt(vh) < OPT["eps"]
            close_params(got["p"][k], jp[k], ill[k])
            close(got["mu"][k], jopt["mu"][k], 1e-5, GRAD_ATOL)
            close(got["nu"][k], jopt["nu"][k], 1e-5, 1e-9)


def test_donated_step_is_bitwise_the_functional_one():
    cfg = t_moon.SMOKE
    w = numpy_weights(j_moon.SMOKE)
    toks = torch.tensor(batch(cfg, 0))
    out = []
    for donate in (False, True):
        step = TL.lm_train_step(cfg, null_plan(), TA.AdamWConfig(**OPT),
                                n_microbatches=2, donate=donate)
        params = lm_params_from_numpy(w, "cpu")
        opt = TA.adamw_init(params)
        given = leaves((params, opt["mu"], opt["nu"]))
        params, opt, m = step(params, opt, toks)
        got = leaves((params, opt["mu"], opt["nu"]))
        assert all((a is b) == donate for a, b in zip(given, got))
        out.append((m["loss"], got))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_arctic_int8_state_from_the_reference():
    """The reference's int8 AdamW state after a step of arctic's update
    (``OPT_CFG``'s moments) on seeded gradients, in the port bit for bit
    through ``adamw_state_from_numpy``; one more update from it in both
    packages, its parameters held as the train steps' are."""
    assert t_arctic.OPT_CFG.moments_dtype == "int8"
    cfg = dict(OPT, moments_dtype="int8")
    w = numpy_weights(j_arctic.SMOKE, seed=3)
    rng = np.random.default_rng(4)
    grads = [{k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in w.items()} for _ in range(2)]
    jcfg = JA.AdamWConfig(**cfg)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    jupdate = jax.jit(lambda p, g, s: JA.adamw_update(jcfg, p, g, s))
    jp, jopt, _ = jupdate(jp, {k: jnp.asarray(v) for k, v in
                               grads[0].items()}, JA.adamw_init(jp, jcfg))
    host = jax.tree.map(np.asarray, jopt)
    topt = adamw_state_from_numpy(host, "cpu")
    assert topt["mu"]["moe_gate"]["q"].dtype == torch.int8
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(host)[0],
                            leaves(topt)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
    tparams = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tparams, _, _ = TA.adamw_update(
        TA.AdamWConfig(**cfg), tparams,
        {k: torch.tensor(v) for k, v in grads[1].items()}, topt)
    jp, jopt, _ = jupdate(jp, {k: jnp.asarray(v) for k, v in
                               grads[1].items()}, jopt)
    for k in jp:
        vh = nu_hat(jax.tree.map(np.asarray, jopt["nu"][k]), 2)
        close_params(tparams[k], jp[k], np.sqrt(vh) < OPT["eps"])
