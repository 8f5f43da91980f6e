"""The port's dense decoder-only LM (``repro_torch.models.transformer``)
vs the JAX package, on the CPU.

Weights are numpy draws from a seed (N(0, 0.02²) matrices, norms 1 ±
0.1, biases N(0, 0.02²)) at each dense config's ``SMOKE`` (float32),
passed to the reference as they are and to the port through
``convert.lm_params_from_numpy``. Tolerances (each element within rtol
of the reference's value, plus rtol times the output's largest |x|:
entries near 0 carry the rounding of larger terms, 4.8e-7 absolute at
most in the attention here):

* ``rms_norm``, ``rope``, ``gqa_attention`` (one block; causal; chunked
  with ``q_chunk`` 8 at S = 32; a causal offset against a longer key
  row) and ``dense_ffn``: rtol 1e-6; and in bfloat16 ``gqa_attention``
  and its gradients bit for bit a plain torch transcription of the
  reference's block (the same per-head products, then the division by
  ``sqrt(dh)``, ``where`` and the float32 softmax), which the port's
  exact query scaling and in-place causal fill must not change;
* ``forward`` and ``lm_loss``: rtol 1e-5;
* the gradients of ``lm_loss`` (``tree.value_and_grad`` against
  ``jax.value_and_grad``): rtol 1e-5, atol 1e-7;
* ``init_kv_cache``/``decode_step`` at ``cache_len`` 0 and 5 (a seeded
  cache): the logits at rtol 1e-5 and the caches the reference returns,
  which the port writes in place into the tensors it was given; and in
  the port alone, decoding a sequence token by token from an empty cache
  gives ``forward``'s logits within 1e-5 of their largest |x|.

In the port alone: remat on and off give the same loss and gradients bit
for bit; ``param_count``/``active_param_count`` equal the reference's
for all five ``FULL`` configs, the two MoE ones included (their model
tests are in ``test_torch_moe.py``). In bfloat16
(each ``SMOKE`` config with ``dtype`` bfloat16, the same weights rounded
to bfloat16 in both packages) the forward's logits lie within 0.032 of
their largest |x| of the reference's: 4× the largest distance measured
on the CPU (0.0079, starcoder2-3b; qwen2-0.5b 0.0068, qwen2.5-3b 0.0060),
one or two bfloat16 ulps of the largest logit.
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

import repro.configs.arctic_480b as j_arctic  # noqa: E402
import repro.configs.lm_common as JL  # noqa: E402
import repro.configs.moonshot_v1_16b_a3b as j_moon  # noqa: E402
import repro.configs.qwen2_0p5b as j_q05  # noqa: E402
import repro.configs.qwen2p5_3b as j_q3  # noqa: E402
import repro.configs.starcoder2_3b as j_sc  # noqa: E402
import repro.models.transformer as JT  # noqa: E402
import repro_torch.configs.lm_common as TL  # noqa: E402
import repro_torch.configs.qwen2_0p5b as t_q05  # noqa: E402
import repro_torch.configs.qwen2p5_3b as t_q3  # noqa: E402
import repro_torch.configs.starcoder2_3b as t_sc  # noqa: E402
import repro_torch.models.transformer as TT  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models.sharding import null_plan  # noqa: E402
from repro_torch.tree import value_and_grad  # noqa: E402
from torch_lm_helpers import plain_attention  # noqa: E402

DENSE = {"qwen2-0.5b": (j_q05, t_q05), "qwen2.5-3b": (j_q3, t_q3),
         "starcoder2-3b": (j_sc, t_sc)}
BF16_TOL = 0.032


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
        if k.endswith("norm"):
            out[k] = 1 + 0.1 * rng.normal(size=shape)
        else:
            out[k] = 0.02 * rng.normal(size=shape)
        out[k] = out[k].astype(np.float32)
    return out


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(DENSE))
def model(request):
    jm, tm = DENSE[request.param]
    w = numpy_weights(jm.SMOKE)
    return dict(jcfg=jm.SMOKE, tcfg=tm.SMOKE,
                jp={k: jnp.asarray(v) for k, v in w.items()},
                tp=lm_params_from_numpy(w, "cpu"),
                toks=tokens(jm.SMOKE, (2, 33)))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    s = rng.normal(size=24).astype(np.float32)
    close(TT.rms_norm(torch.tensor(x), torch.tensor(s), 1e-6),
          JT.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6), 1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None] + 7, (2, 32))
    close(TT.rope(torch.tensor(x), torch.tensor(pos), theta),
          JT.rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-6)


@pytest.mark.parametrize("kw,T,dh", [
    (dict(), 32, 8),                               # one block, no mask
    (dict(causal_offset=0), 32, 8),                # causal
    (dict(causal_offset=0, q_chunk=8), 32, 8),     # 4 chunks of 8 rows
    (dict(causal_offset=0, q_chunk=12), 32, 8),    # 32 % 12: one block
    (dict(causal_offset=5, q_chunk=8), 48, 8),     # an offset, longer keys
    (dict(causal_offset=0, q_chunk=8), 32, 16),    # sqrt(dh) a power of 2
])
def test_gqa_attention(kw, T, dh):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 32, 6, dh)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, dh)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, dh)).astype(np.float32)
    got = TT.gqa_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           **kw)
    want = JT.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    assert got.shape == want.shape
    close(got, want, 1e-6)


@pytest.mark.parametrize("S,T,dh,offset,chunk", [
    (32, 32, 64, 0, 8),      # sqrt(dh) = 8: the queries are scaled
    (32, 32, 32, 0, 8),      # sqrt(dh) ≈ 5.66: the scores are divided
    (16, 48, 64, 32, 8),     # an offset against a longer key row
    (1, 40, 64, 20, 1),      # one decoded token, a part-filled cache
])
def test_gqa_attention_bf16_is_bitwise_the_plain_form(S, T, dh, offset,
                                                      chunk):
    gen = torch.Generator().manual_seed(7)
    q, d = (torch.randn((2, S, 6, dh), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    k, v = (torch.randn((2, T, 2, dh), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    runs = []
    for fn in (lambda *a: TT.gqa_attention(*a, causal_offset=offset,
                                           q_chunk=chunk),
               lambda *a: plain_attention(*a, offset, chunk)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        runs.append((out, *torch.autograd.grad(out, leaves, d)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_dense_ffn():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    g, u = (0.3 * rng.normal(size=(16, 40)).astype(np.float32)
            for _ in range(2))
    d = 0.3 * rng.normal(size=(40, 16)).astype(np.float32)
    close(TT.dense_ffn(*map(torch.tensor, (x, g, u, d))),
          JT.dense_ffn(*map(jnp.asarray, (x, g, u, d))), 1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_and_loss(model):
    t = torch.tensor(model["toks"])
    with torch.no_grad():
        logits = TT.forward(model["tcfg"], model["tp"], t[:, :-1])
        loss = TT.lm_loss(model["tcfg"], model["tp"], t)
    want = JT.forward(model["jcfg"], model["jp"],
                      jnp.asarray(model["toks"][:, :-1]))
    assert logits.shape == want.shape
    close(logits, want, 1e-5)
    close(loss, JT.lm_loss(model["jcfg"], model["jp"],
                           jnp.asarray(model["toks"])), 1e-5)


def test_gradients(model):
    toks = model["toks"]
    loss, grads = value_and_grad(
        lambda p: TT.lm_loss(model["tcfg"], p, torch.tensor(toks)),
        model["tp"])
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(model["jcfg"], p, jnp.asarray(toks)))(
        model["jp"])
    close(loss, jloss, 1e-5)
    assert grads.keys() == jgrads.keys()
    for k in grads:
        close(grads[k], jgrads[k], 1e-5, atol=1e-7)
        assert (grads[k] != 0).any(), k


@pytest.mark.parametrize("cache_len", [0, 5])
def test_decode_step(model, cache_len):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    B, T = 2, 12
    jcache = JT.init_kv_cache(jcfg, B, T)
    tcache = TT.init_kv_cache(tcfg, B, T, device="cpu")
    assert all(tc.shape == jc.shape and tc.dtype == torch.float32
               and not tc.any() for tc, jc in zip(tcache, jcache))
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
    jlogits, jnew = JT.decode_step(jcfg, model["jp"], jnp.asarray(tok),
                                   jcache, cache_len)
    assert logits.shape == jlogits.shape == (B, 1, jcfg.vocab)
    close(logits, jlogits, 1e-5)
    for got, given, want in zip(new, tcache, jnew):
        assert got is given                        # written in place
        close(got, want, 1e-5)


def test_decode_token_by_token_matches_forward(model):
    cfg, p = model["tcfg"], model["tp"]
    t = torch.tensor(tokens(cfg, (3, 20), seed=2))
    with torch.no_grad():
        full = TT.forward(cfg, p, t)
        cache = TT.init_kv_cache(cfg, 3, 20, device="cpu")
        ptrs = [c.data_ptr() for c in cache]
        steps = []
        for i in range(20):
            logits, cache = TT.decode_step(cfg, p, t[:, i:i + 1], cache, i)
            steps.append(logits)
    assert [c.data_ptr() for c in cache] == ptrs
    close(torch.cat(steps, 1), full, 1e-5, atol=1e-5 * float(
        full.abs().max()))


def test_remat_on_and_off_are_bitwise_equal(model):
    toks = torch.tensor(model["toks"])
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(model["tcfg"], remat=remat, q_chunk=8)
        out.append(value_and_grad(lambda p: TT.lm_loss(cfg, p, toks),
                                  model["tp"]))
    (l1, g1), (l0, g0) = out
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[k], g0[k]) for k in g1)


def test_bfloat16_logits(model):
    jcfg = dataclasses.replace(model["jcfg"], dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(model["tcfg"], dtype=torch.bfloat16)
    jp = {k: v.astype(jnp.bfloat16) for k, v in model["jp"].items()}
    tp = lm_params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              "cpu")
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    assert all(np.array_equal(tp[k].view(torch.int16).numpy(),
                              np.asarray(jp[k]).view(np.int16)) for k in jp)
    toks = model["toks"][:, :-1]
    with torch.no_grad():
        got = TT.forward(tcfg, tp, torch.tensor(toks))
    want = np.asarray(JT.forward(jcfg, jp, jnp.asarray(toks)).astype(
        jnp.float32))
    assert got.dtype == torch.bfloat16
    dist = float(np.abs(got.float().numpy() - want).max())
    assert dist <= BF16_TOL * np.abs(want).max(), dist


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def port_config(ref_cfg):
    """The port's TransformerConfig with every field of ``ref_cfg``."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["dtype"] = torch.bfloat16 if ref_cfg.dtype == jnp.bfloat16 \
        else torch.float32
    if ref_cfg.moe is not None:
        kw["moe"] = TT.MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    return TT.TransformerConfig(**kw)


@pytest.mark.parametrize("jm", [j_q05, j_q3, j_sc, j_arctic, j_moon],
                         ids=lambda m: m.FULL.name)
def test_param_counts(jm):
    cfg = port_config(jm.FULL)
    assert cfg.param_count() == jm.FULL.param_count()
    assert cfg.active_param_count() == jm.FULL.active_param_count()
    assert cfg.d_head == jm.FULL.d_head


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_configs_are_the_reference_configs(name):
    jm, tm = DENSE[name]
    for which in ("FULL", "SMOKE"):
        assert port_config(getattr(jm, which)) == getattr(tm, which)


def test_lm_shapes_are_the_reference_shapes():
    assert TL.LM_SHAPES == JL.LM_SHAPES
    assert TL.SHAPE_DIMS == JL.SHAPE_DIMS


def test_init_params_layout_and_default_device():
    cfg = t_q05.SMOKE
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(lambda k: JT.init_params(k, j_q05.SMOKE),
                            jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in shapes.items()}
    assert torch.equal(p["bq"], torch.zeros_like(p["bq"]))
    assert torch.equal(p["attn_norm"], torch.ones_like(p["attn_norm"]))
    assert 0.015 < float(p["wq"].std()) < 0.025
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TT.init_kv_cache(cfg, 1, 4)


def test_null_plan_is_the_identity():
    x = torch.ones(2, 3)
    assert null_plan().shard(x, "act") is x
