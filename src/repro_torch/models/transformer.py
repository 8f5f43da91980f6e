"""Decoder-only transformer family, dense part: torch port of
``repro.models.transformer`` (GQA + RoPE (+ QKV bias) with a gated dense
FFN).

One parameterisation covers the three dense LM architectures (qwen2-0.5b,
qwen2.5-3b, starcoder2-3b). Layers are *stacked* (``[L, ...]`` leaves, the
reference's tree and key names); the forward takes each stacked leaf apart
once (``torch.unbind``) and runs the layers in a Python loop, under
``cfg.remat`` each inside ``torch.utils.checkpoint``. The configs keep the
reference's MoE fields and parameter counts, but the MoE block
(``moe_ffn``: capacity-based top-k dispatch and combine, two scatter-adds)
is not ported yet: ``init_params``, ``forward`` and ``decode_step`` raise
``NotImplementedError`` for a config with ``moe`` (ROADMAP A13b).

The casts are the reference's, in its order, because they decide the
bfloat16 bits: RMSNorm's variance in float32 and its ``rsqrt`` cast to
the activation dtype; RoPE's angles in float32 and ``cos``/``sin`` cast
to it; attention scores in the activation dtype, divided by ``sqrt(dh)``
there (a power-of-two divisor as an exact scaling of the queries) and
masked with its ``finfo.min``; the softmax in float32, cast back before
the product with V; the loss's log-sum-exp and gold logit in
float32. Products are ``torch.matmul``/``bmm`` (cuBLAS on the card; no
Pallas kernel stands behind this path in the reference).

Attention keeps the reference's row-exact chunked form: query blocks of
``q_chunk`` rows, each against its full key row (no online rescaling). The
score products run one KV head at a time, on strided views of K and V, so
that neither a 32,768-slot decode cache nor a training K is copied into
another layout. ``decode_step`` writes the new tokens' K/V into the cache
in place (the reference's functional ``dynamic_update_slice`` would
double a 51.5-GB cache) and returns the same tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.sharding import ShardingPlan, null_plan


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN + MoE in parallel
    n_shared: int = 0              # moonshot/DeepSeek shared experts


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = torch.bfloat16
    # memory controls (production defaults): remat recomputes each layer in
    # the backward pass; q_chunk bounds the attention-score working set to
    # [B, H, q_chunk, S] (row-exact softmax: each block keeps its full key
    # row)
    remat: bool = True
    q_chunk: Optional[int] = 1024

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters (N for the 6·N·D model-FLOPs accounting)."""
        d, L = self.d_model, self.n_layers
        attn = d * self.n_heads * self.d_head \
            + 2 * d * self.n_kv_heads * self.d_head \
            + self.n_heads * self.d_head * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        ffn = 3 * d * self.d_ff  # gated (SwiGLU) dense branch
        per_layer = attn + 2 * d  # + norms
        if self.moe is None:
            per_layer += ffn
        else:
            m = self.moe
            per_layer += m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
            per_layer += m.n_shared * 3 * d * m.d_ff_expert
            if m.dense_residual:
                per_layer += ffn
        return L * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE: only routed-to experts)."""
        if self.moe is None:
            return self.param_count()
        d, L, m = self.d_model, self.n_layers, self.moe
        total = self.param_count()
        routed_all = L * m.n_experts * 3 * d * m.d_ff_expert
        routed_active = L * m.top_k * 3 * d * m.d_ff_expert
        return total - routed_all + routed_active


def _dense_only(cfg: TransformerConfig, what: str) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{what}: {cfg.name} has an MoE block, and moe_ffn (its "
            "dispatch and combine) is not ported yet (ROADMAP A13b)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's parameter tree (its key names, stacked ``[L, ...]``
    layer leaves) in ``cfg.dtype``: N(0, 0.02²) weights drawn in float32
    from ``generator`` on its own device, unit norms, zero biases; on
    ``device`` (default: the CUDA card)."""
    _dense_only(cfg, "init_params")
    device = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers
    dh, H, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads

    def s(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * 0.02).to(device=device, dtype=cfg.dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=cfg.dtype, device=device)

    p = dict(
        embed=s(cfg.vocab, d),
        final_norm=full((d,), 1.0),
        lm_head=s(d, cfg.vocab),
        attn_norm=full((L, d), 1.0),
        ffn_norm=full((L, d), 1.0),
        wq=s(L, d, H * dh),
        wk=s(L, d, Hkv * dh),
        wv=s(L, d, Hkv * dh),
        wo=s(L, H * dh, d),
    )
    if cfg.qkv_bias:
        p["bq"] = full((L, H * dh), 0.0)
        p["bk"] = full((L, Hkv * dh), 0.0)
        p["bv"] = full((L, Hkv * dh), 0.0)
    p["w_gate"] = s(L, d, cfg.d_ff)
    p["w_up"] = s(L, d, cfg.d_ff)
    p["w_down"] = s(L, cfg.d_ff, d)
    return p


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x, positions, theta):
    """x: [..., S, H, dh]; rotate pairs (standard LLaMA/Qwen RoPE)."""
    dh = x.shape[-1]
    half = dh // 2
    f32 = torch.float32
    log_theta = torch.log(torch.full((), theta, dtype=f32, device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(0, half, dtype=f32,
                                                device=x.device) / half)
    ang = positions[..., :, None].to(f32) * freqs[None, :]    # [.., S, half]
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _score_scale(dh: int, dtype, device):
    """``(q_scale, score_scale)``, of which one is ``None``: the two ways to
    take ``scores / sqrt(dh)``, the divisor rounded to float32 and then to
    ``dtype``. A power-of-two divisor (dh = 64 gives 8) divides exactly as
    a product with its inverse, and such a product commutes with the score
    product's sums and roundings (and with its backward's), so it scales
    the queries (a pass over ``[B, Sq, H, dh]``, not over the scores);
    any other divisor divides the scores by a tensor on the device (a host
    scalar divisor becomes an inexact reciprocal product on the card)."""
    c = float(torch.tensor(math.sqrt(dh), dtype=torch.float32).to(dtype))
    if math.frexp(c)[0] == 0.5:
        inv = 1.0 / c
        return (lambda q: q * inv), None
    divisor = torch.full((), c, dtype=dtype, device=device)
    return None, (lambda scores: scores / divisor)


def _causal_fill_(x, g, q_start, offset, value):
    """``x[:, r·g + i, j] = value`` wherever key ``j`` lies after query
    ``q_start + r + offset``, in place on ``x`` [B, Sq·g, T] (a query
    block's scores of one KV head's g query heads): the columns that every
    row masks are filled, and only the band between, where the rows
    differ, goes through the mask."""
    B, T = x.shape[0], x.shape[2]
    Sq = x.shape[1] // g
    x = x.view(B, Sq, g, T)
    lo = min(max(q_start + offset + 1, 0), T)   # no row masks a column < lo
    hi = min(max(q_start + offset + Sq, 0), T)  # every row masks one ≥ hi
    if hi < T:
        x[..., hi:].fill_(value)
    if lo < hi:
        r = torch.arange(Sq, device=x.device)[:, None]
        j = torch.arange(lo, hi, device=x.device)[None, :]
        x[..., lo:hi].masked_fill_((j > q_start + offset + r)[:, None, :],
                                   value)


class _CausalMask(torch.autograd.Function):
    """The reference's ``where(key <= query, scores, finfo.min)`` on a
    block's fresh scores, in place (``_causal_fill_``); its backward zeroes
    the same entries of the gradient, as ``where``'s does. The gradient
    that arrives is the softmax backward's own new tensor, its only use."""

    @staticmethod
    def forward(ctx, scores, g, q_start, offset):
        ctx.args = (g, q_start, offset)
        ctx.mark_dirty(scores)
        _causal_fill_(scores, *ctx.args, torch.finfo(scores.dtype).min)
        return scores

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        grad = grad.contiguous()
        _causal_fill_(grad, *ctx.args, 0)
        return grad, None, None, None


def _attn_block(qs, ks, vs, scales, q_start, causal_offset):
    """One query block against full key rows, a KV head at a time:
    ``qs[h]`` [B, Sq, g, dh] (the block's queries of KV head h, starting
    at row ``q_start``), ``ks[h]``/``vs[h]`` [B, T, dh] (strided views of
    K and V), ``scales`` from ``_score_scale``; returns
    [B, Sq, Hkv, g, dh]."""
    q_scale, score_scale = scales
    B, Sq, g, dh = qs[0].shape
    outs = []
    for qh, kh, vh in zip(qs, ks, vs):
        if q_scale is not None:
            qh = q_scale(qh)
        scores = torch.bmm(qh.reshape(B, Sq * g, dh), kh.transpose(1, 2))
        if score_scale is not None:
            scores = score_scale(scores)
        if causal_offset is not None:
            scores = _CausalMask.apply(scores, g, q_start, causal_offset)
        w = torch.softmax(scores.float(), dim=-1).to(qh.dtype)
        out = torch.bmm(w, vh)
        outs.append(out.view(B, Sq, g, dh))
    return torch.stack(outs, dim=2)


def gqa_attention(q, k, v, causal_offset=None, q_chunk=None):
    """q: [B,S,H,dh], k/v: [B,T,Hkv,dh]. GQA: H = g·Hkv.

    ``q_chunk`` streams query blocks through a Python loop so the
    [.., S, T] score tensor never materialises beyond one block (exact
    softmax: each block keeps its full key row)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    q = q.reshape(B, S, Hkv, g, dh)
    scales = _score_scale(dh, q.dtype, q.device)
    ks, vs = k.unbind(2), v.unbind(2)
    if q_chunk is None or S <= q_chunk or S % q_chunk != 0:
        out = _attn_block(q.unbind(2), ks, vs, scales, 0, causal_offset)
        return out.reshape(B, S, H, dh)
    outs = [_attn_block(qb.unbind(2), ks, vs, scales, i * q_chunk,
                        causal_offset)
            for i, qb in enumerate(q.split(q_chunk, dim=1))]
    return torch.cat(outs, dim=1).reshape(B, S, H, dh)


def dense_ffn(x, gate, up, down):
    return torch.matmul(F.silu(torch.matmul(x, gate))
                        * torch.matmul(x, up), down)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _layer(cfg: TransformerConfig, plan: ShardingPlan, x, lw, positions,
           kv_cache=None, cache_len=None):
    """One transformer block. Returns (x, new_kv): new_kv is (k, v) of this
    call's tokens, or with ``kv_cache`` the layer's cache, into which this
    call's k/v were written at ``cache_len`` in place."""
    B, S, d = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    h = rms_norm(x, lw["attn_norm"], cfg.norm_eps)
    q = torch.matmul(h, lw["wq"])
    k = torch.matmul(h, lw["wk"])
    v = torch.matmul(h, lw["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = plan.shard(q.reshape(B, S, H, dh), "act_heads")
    k = k.reshape(B, S, Hkv, dh)
    v = v.reshape(B, S, Hkv, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_len + S > ck.shape[1]:
            raise ValueError(f"decode: {S} new token(s) at cache_len "
                             f"{cache_len} do not fit a cache of "
                             f"{ck.shape[1]} slots")
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        att = gqa_attention(q, ck, cv, causal_offset=cache_len,
                            q_chunk=cfg.q_chunk)
        new_kv = (ck, cv)
    else:
        att = gqa_attention(q, k, v, causal_offset=0, q_chunk=cfg.q_chunk)
        new_kv = (k, v)

    att = plan.shard(att, "act_heads")
    x = x + torch.matmul(att.reshape(B, S, H * dh), lw["wo"])
    x = plan.shard(x, "act")

    h = rms_norm(x, lw["ffn_norm"], cfg.norm_eps)
    y = dense_ffn(h, lw["w_gate"], lw["w_up"], lw["w_down"])
    x = plan.shard(x + y, "act")
    return x, new_kv


_STACKED = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
            "w_gate", "w_up", "w_down")


def _layer_weights(params: dict) -> list:
    """Each layer's weights, ``[{name: [...] leaf}]``: one ``unbind`` a
    stacked leaf, so that autograd stacks each ``[L, ...]`` gradient once
    (a select a layer would zero-fill the whole leaf's gradient L times)."""
    parts = {k: torch.unbind(v) for k, v in params.items() if k in _STACKED}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            plan: ShardingPlan = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (training / prefill path)."""
    _dense_only(cfg, "forward")
    plan = plan or null_plan()
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"])
    x = plan.shard(x, "act")
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    def body(x, lw):
        return _layer(cfg, plan, x, lw, positions)[0]

    for lw in _layer_weights(params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, lw, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, lw)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, params["lm_head"])
    return plan.shard(logits, "logits")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    """Mean of ``logsumexp(logits) - logits[target]`` in float32. The gold
    logit is taken before its cast to float32 (the same value; its
    gradient is scattered in the activation dtype, as the reference's
    cast's is)."""
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold.float())


def lm_loss(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            plan: ShardingPlan = None) -> torch.Tensor:
    """Next-token cross entropy (the train_step objective)."""
    logits = forward(cfg, params, tokens[:, :-1], plan)
    return cross_entropy(logits, tokens[:, 1:])


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, device=None) -> tuple:
    """Zero K and V caches ``[L, B, max_len, Hkv, dh]`` in ``dtype``
    (default ``cfg.dtype``) on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                kv_cache: tuple, cache_len: int, plan: ShardingPlan = None):
    """One-token decode: tokens [B, 1]; kv_cache ([L,B,T,Hkv,dh] ×2).

    Returns (logits [B, 1, V], kv_cache): this call's K/V are written into
    the cache at ``cache_len`` in place, and the cache returned is the one
    given. ``cache_len`` (a host int) is the number of valid cache entries
    before the call."""
    _dense_only(cfg, "decode_step")
    plan = plan or null_plan()
    cache_len = int(cache_len)
    B, S = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = (cache_len + torch.arange(S, device=tokens.device))[
        None].expand(B, S)
    ck, cv = kv_cache
    for i, lw in enumerate(_layer_weights(params)):
        x, _ = _layer(cfg, plan, x, lw, positions, kv_cache=(ck[i], cv[i]),
                      cache_len=cache_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, params["lm_head"])
    return plan.shard(logits, "logits"), (ck, cv)
