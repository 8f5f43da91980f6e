"""Decoder-only transformer family: torch port of
``repro.models.transformer`` (GQA + RoPE (+ QKV bias) with a gated dense
FFN or a capacity-based top-k MoE).

One parameterisation covers the five LM architectures: qwen2-0.5b,
qwen2.5-3b and starcoder2-3b (dense), arctic-480b (MoE with a dense
residual FFN beside it) and moonshot-v1-16b-a3b (MoE with shared
experts). Layers are *stacked* (``[L, ...]`` leaves, the reference's tree
and key names); the forward takes each stacked leaf apart once
(``torch.unbind``) and runs the layers in a Python loop, under
``cfg.remat`` each inside ``torch.utils.checkpoint``.

The casts are the reference's, in its order, because they decide the
bfloat16 bits: RMSNorm's variance in float32 and its ``rsqrt`` cast to
the activation dtype; RoPE's angles in float32 and ``cos``/``sin`` cast
to it; attention scores in the activation dtype, divided by ``sqrt(dh)``
there (a power-of-two divisor as an exact scaling of the queries) and
masked with its ``finfo.min``; the softmax in float32, cast back before
the product with V; the router's logits in the activation dtype and its
softmax in float32; the loss's log-sum-exp and gold logit in float32.
Products are ``torch.matmul``/``bmm`` (cuBLAS on the card; no Pallas
kernel stands behind this path in the reference).

Attention keeps the reference's row-exact chunked form: query blocks of
``q_chunk`` rows, each against its full key row (no online rescaling). The
score products run one KV head at a time, on strided views of K and V, so
that neither a 32,768-slot decode cache nor a training K is copied into
another layout. ``decode_step`` writes the new tokens' K/V into the cache
in place (the reference's functional ``dynamic_update_slice`` would
double a 51.5-GB cache) and returns the same tensors.

``moe_ffn`` keeps the reference's routing bit for bit: the top k of a
*stable* descending sort of the router probabilities (``jax.lax.top_k``
puts the lower expert first among equal values; ``torch.topk`` promises
no order), each entry's queue position its rank among the entries of its
expert in token-major order, and the capacity rule. Its dispatch and
combine differ from the reference's two scatter-adds in form only (a
deviation of the port, for determinism): the kept entries' slots are
unique, so the dispatch writes rows and the combine gathers them, and
each one's gradient is the other (``_Dispatch``, ``_Combine``). The only
float sums are over a token's k entries, in entry order. So the forward
and backward of ``moe_ffn`` hold no float atomic (no ``index_add_``,
``scatter_add_`` or accumulating ``index_put_``), and a repeat gives the
same bits.
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's parameter tree (its key names, stacked ``[L, ...]``
    layer leaves) in ``cfg.dtype``: N(0, 0.02²) weights drawn in float32
    from ``generator`` on its own device, unit norms, zero biases; on
    ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers
    dh, H, Hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads

    def s(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return w.mul_(0.02).to(device=device, dtype=cfg.dtype)

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
    if cfg.moe is None or cfg.moe.dense_residual:
        p["w_gate"] = s(L, d, cfg.d_ff)
        p["w_up"] = s(L, d, cfg.d_ff)
        p["w_down"] = s(L, cfg.d_ff, d)
    if cfg.moe is not None:
        m = cfg.moe
        p["router"] = s(L, d, m.n_experts)
        p["moe_gate"] = s(L, m.n_experts, d, m.d_ff_expert)
        p["moe_up"] = s(L, m.n_experts, d, m.d_ff_expert)
        p["moe_down"] = s(L, m.n_experts, m.d_ff_expert, d)
        if m.n_shared:
            p["shared_gate"] = s(L, d, m.n_shared * m.d_ff_expert)
            p["shared_up"] = s(L, d, m.n_shared * m.d_ff_expert)
            p["shared_down"] = s(L, m.n_shared * m.d_ff_expert, d)
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


@dataclasses.dataclass(frozen=True)
class MoERoute:
    """The routing of ``[shards, Tl]`` tokens: ``probs`` [s, Tl, E] (the
    router's float32 softmax), ``idx`` [s, Tl, k] (each token's experts,
    highest probability first, the lower expert first among equal
    values), ``gate`` [s, Tl, k] (their probabilities over their sum,
    float32, differentiable), ``pos`` [s, Tl, k] (each entry's rank among
    its shard's entries routed to its expert, in token-major order),
    ``keep`` [s, Tl, k] (``0 <= pos < cap``) and ``cap``."""
    probs: torch.Tensor
    idx: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def moe_route(xt, router, m: MoEConfig) -> MoERoute:
    """The reference's routing (``moe_ffn``'s top-k, positions and
    capacity) of ``xt`` [shards, Tl, d]."""
    s, Tl, _ = xt.shape
    E, k = m.n_experts, m.top_k
    logits = torch.matmul(xt, router.to(xt.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k's order: a stable descending sort (lower index first
    # among ties); its backward writes each value's gradient back to its
    # one source (a scatter, no add)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    gate = vals[..., :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(m.capacity_factor * Tl * k / E), k, 1)
    # the reference's one-hot running count, laid out [s, E, Tl·k] so that
    # the count runs along the innermost dim: along dim 1 of [s, Tl·k, E]
    # the scan took 4.7 ms a call at Tl·k = 24,576, E = 64 (NVIDIA H100
    # 80GB HBM3, 700 W; PERF.md §6)
    flat = idx.reshape(s, 1, Tl * k)
    experts = torch.arange(E, device=idx.device)[None, :, None]
    ranks = (flat == experts).cumsum(-1)                  # [s, E, Tl·k]
    pos = (ranks.gather(1, flat) - 1).reshape(s, Tl, k)
    keep = (pos < cap) & (pos >= 0)
    return MoERoute(probs, idx, gate, pos, keep, cap)


class _Dispatch(torch.autograd.Function):
    """``buf[slot[t, j]] = x[t]`` for every kept entry ``(t, j)`` of
    ``x`` [N, d], into a zero ``[n_slots, d]`` buffer (``slot`` [N, k]
    holds ``n_slots`` for a dropped entry, whose row is written to a
    spare row and discarded). Kept slots are unique, so rows are written,
    not added: ``x + 0.0`` first, so that ``-0.0`` lands as ``+0.0``, as
    the reference's add into zeros gives. The backward gathers each kept
    entry's gradient row and sums a token's k rows in entry order."""

    @staticmethod
    def forward(ctx, x, slot, keep, n_slots):
        ctx.save_for_backward(slot, keep)
        x0 = x + 0.0
        buf = x.new_zeros((n_slots + 1, x.shape[1]))
        for j in range(slot.shape[1]):
            buf.index_put_((slot[:, j],), x0)
        return buf[:n_slots]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        slot, keep = ctx.saved_tensors
        safe = torch.where(keep, slot, 0)
        gx = None
        for j in range(slot.shape[1]):
            g = torch.where(keep[:, j, None],
                            grad.index_select(0, safe[:, j]), 0)
            gx = g if gx is None else gx + g
        return gx, None, None, None


class _Combine(torch.autograd.Function):
    """``rows[t, j] = buf[slot[t, j]]`` for the kept entries and 0 for the
    dropped ones (the reference's clamped gather times ``keep``), [N, k, d]
    from ``buf`` [n_slots, d]. The backward writes each kept entry's
    gradient row to its slot (unique) in a zero buffer."""

    @staticmethod
    def forward(ctx, buf, slot, keep):
        ctx.save_for_backward(slot)
        ctx.n_slots = buf.shape[0]
        safe = torch.where(keep, slot, 0)
        rows = buf.index_select(0, safe.reshape(-1)).view(
            *slot.shape, buf.shape[1])
        return torch.where(keep[..., None], rows, 0)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        d = grad.shape[-1]
        gbuf = grad.new_zeros((ctx.n_slots + 1, d))
        gbuf.index_put_((slot.reshape(-1),), grad.reshape(-1, d))
        return gbuf[:ctx.n_slots], None, None


def moe_ffn(x, lw, m: MoEConfig, plan: ShardingPlan):
    """Capacity-based top-k dispatch (GShard) of ``x`` [B, S, d].

    Dispatch positions are computed PER TOKEN SHARD
    (``plan.moe_token_shards``; 1 when it does not divide the B·S tokens),
    each shard with its own expert queues of ``MoERoute.cap`` slots;
    entries past an expert's capacity drop (standard GShard semantics).
    The queues of all shards sit in one ``[E, shards·cap, d]`` buffer, so
    that each expert's three products are one batched product over E.
    The combine scales each kept entry's expert output by its gate value
    in the activation dtype and sums a token's k entries in entry order;
    the shared experts (``n_shared``) are added after it."""
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    shards = plan.moe_token_shards or 1
    if T % shards != 0:
        shards = 1
    Tl = T // shards
    xt = x.reshape(shards, Tl, d)
    r = moe_route(xt, lw["router"], m)
    n_slots = E * shards * r.cap
    shard = torch.arange(shards, device=x.device)[:, None, None]
    slot = torch.where(r.keep, r.idx * (shards * r.cap) + shard * r.cap
                       + r.pos, n_slots).reshape(T, k)
    keep = r.keep.reshape(T, k)

    buf = _Dispatch.apply(x.reshape(T, d), slot, keep, n_slots).view(
        E, shards * r.cap, d)
    h = F.silu(torch.bmm(buf, lw["moe_gate"])) * torch.bmm(buf, lw["moe_up"])
    out_buf = torch.bmm(h, lw["moe_down"]).view(n_slots, d)

    rows = _Combine.apply(out_buf, slot, keep)               # [T, k, d]
    terms = (rows * r.gate.reshape(T, k, 1).to(x.dtype)).unbind(1)
    out = terms[0]
    for t in terms[1:]:
        out = out + t

    if m.n_shared:
        xf = x.reshape(T, d)
        shared = F.silu(torch.matmul(xf, lw["shared_gate"])) * torch.matmul(
            xf, lw["shared_up"])
        out = out + torch.matmul(shared, lw["shared_down"])
    return out.reshape(B, S, d)


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
    if cfg.moe is None:
        y = dense_ffn(h, lw["w_gate"], lw["w_up"], lw["w_down"])
    else:
        y = moe_ffn(h, lw, cfg.moe, plan)
        if cfg.moe.dense_residual:
            y = y + dense_ffn(h, lw["w_gate"], lw["w_up"], lw["w_down"])
    x = plan.shard(x + y, "act")
    return x, new_kv


_STACKED = ("attn_norm", "ffn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
            "w_gate", "w_up", "w_down", "router", "moe_gate", "moe_up",
            "moe_down", "shared_gate", "shared_up", "shared_down")


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
