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

On a mesh (a plan with a ``DeviceMesh``, ``models.sharding.make_lm_plan``)
the parameters and tokens are DTensors and the same code runs as one
rank's program, DTensor placing each product and its collectives. Where
the rank must see local shards, a block runs under
``torch.distributed.tensor.experimental.local_map``: RoPE (its tables and
positions are made locally, from the local shapes), the attention on the
rank's heads, the MoE dispatch and combine on the rank's token shard
(each DP rank is one of the reference's ``moe_token_shards``; the experts
between them are DTensor products over the expert-sharded weights), and a
vocab-parallel cross entropy (a local max and log-sum-exp and the gold
logit of the local vocabulary slice, each then all-reduced over
``"model"``). The attention runs head-sharded over ``"model"`` only where
both the heads and the KV heads divide its size; otherwise its heads are
replicated over ``"model"`` (Q, K and V all-gathered, the attention done
on every model rank), as the reference's decode cache falls back from
KV heads to ``d_head`` to replicated (``lm_common``'s ``kv_spec``); the
gathers show in the dry-run's collective bytes. With no mesh
(``null_plan()``) none of this runs: every single-card path is as it was.
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


def param_specs(cfg: TransformerConfig, plan: ShardingPlan) -> dict:
    """The spec tree matching ``init_params``' structure (the reference's
    ``param_specs``)."""
    sp = dict(
        embed=plan.spec("embed"),
        final_norm=plan.spec("norm"),
        lm_head=plan.spec("lm_head"),
        attn_norm=plan.spec("norm"),
        ffn_norm=plan.spec("norm"),
        wq=plan.spec("wq"), wk=plan.spec("wkv"), wv=plan.spec("wkv"),
        wo=plan.spec("wo"),
    )
    if cfg.qkv_bias:
        sp["bq"] = plan.spec("bias_model")
        sp["bk"] = plan.spec("bias_model")
        sp["bv"] = plan.spec("bias_model")
    if cfg.moe is None or cfg.moe.dense_residual:
        sp["w_gate"] = plan.spec("w_in")
        sp["w_up"] = plan.spec("w_in")
        sp["w_down"] = plan.spec("w_out")
    if cfg.moe is not None:
        sp["router"] = plan.spec("router")
        sp["moe_gate"] = plan.spec("moe_w_in")
        sp["moe_up"] = plan.spec("moe_w_in")
        sp["moe_down"] = plan.spec("moe_w_out")
        if cfg.moe.n_shared:
            sp["shared_gate"] = plan.spec("w_in")
            sp["shared_up"] = plan.spec("w_in")
            sp["shared_down"] = plan.spec("w_out")
    return sp


# ---------------------------------------------------------------------------
# placements on a mesh
# ---------------------------------------------------------------------------

def _place(plan: ShardingPlan, batch=0, model=None, dp=None) -> list:
    """Placements on the plan's mesh of a tensor whose dim ``batch`` is
    split over the DP axes (None: not split) and whose dim ``model`` over
    ``"model"`` (None: replicated there). ``dp`` overrides the DP axes'
    placement (``Partial()`` for a partial sum over the batch)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in plan.mesh.mesh_dim_names:
        if name == "model":
            out.append(Replicate() if model is None else Shard(model))
        elif dp is not None:
            out.append(dp)
        else:
            out.append(Replicate() if batch is None else Shard(batch))
    return out          # a list: local_map reads a tuple as several outputs


def _local_map(plan, fn, out_placements, in_placements,
               in_grad_placements=None):
    from torch.distributed.tensor.experimental import local_map

    # inputs placed otherwise (FSDP's weights) are redistributed first
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     device_mesh=plan.mesh, redistribute_inputs=True)


def heads_sharded(cfg: TransformerConfig, plan: ShardingPlan) -> bool:
    """True where the attention runs on each rank's own heads: a mesh
    whose ``"model"`` size divides both the heads and the KV heads."""
    tp = plan.axis_size("model") if plan.mesh is not None else 1
    return (plan.mesh is not None and cfg.n_heads % tp == 0
            and cfg.n_kv_heads % tp == 0)


def _heads(plan, t, n: int, dh: int, sharded: bool):
    """``[B, S, n·dh]`` -> ``[B, S, n, dh]``; on a mesh first placed with
    its heads split over ``"model"`` or, not ``sharded``, replicated
    there (an all-gather of the projection's columns)."""
    B, S = t.shape[:2]
    if plan.mesh is not None:
        t = t.redistribute(plan.mesh, _place(plan, 0, 2 if sharded
                                             else None))
    return t.reshape(B, S, n, dh)


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
    the shared experts (``n_shared``) are added after it. On a mesh see
    :func:`_moe_ffn_mesh`."""
    if plan.mesh is not None:
        return _moe_ffn_mesh(x, lw, m, plan)
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


def _moe_dispatch_local(x, router, m: MoEConfig):
    """One token shard's routing and dispatch: ``x`` [B, S, d] -> (its
    ``[E, cap, d]`` queues, ``slot``/``keep`` [T, k], ``gate`` [T, k])."""
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    r = moe_route(x.reshape(1, T, d), router, m)
    n_slots = E * r.cap
    slot = torch.where(r.keep, r.idx * r.cap + r.pos, n_slots).reshape(T, k)
    keep = r.keep.reshape(T, k)
    buf = _Dispatch.apply(x.reshape(T, d), slot, keep, n_slots)
    return buf.view(E, r.cap, d), slot, keep, r.gate.reshape(T, k)


def _moe_combine_local(out_buf, slot, keep, gate, dtype):
    """One token shard's combine: ``[T, d]`` from its ``[E, cap, d]``
    expert outputs, as :func:`moe_ffn` sums them."""
    T, k = slot.shape
    rows = _Combine.apply(out_buf.reshape(-1, out_buf.shape[-1]), slot, keep)
    terms = (rows * gate.reshape(T, k, 1).to(dtype)).unbind(1)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _moe_ffn_mesh(x, lw, m: MoEConfig, plan: ShardingPlan):
    """``moe_ffn`` on a mesh: each DP rank's tokens are one token shard
    (``plan.moe_token_shards`` is the DP size), routed and dispatched under
    ``local_map`` into its queues, which form the ``[E, shards·cap, d]``
    buffer split over the DP axes. The expert products are DTensor
    products over the weights' expert split (``"model"``); the outputs are
    all-gathered over ``"model"`` and combined under ``local_map``."""
    B, S, d = x.shape
    tok = _place(plan, 0)                         # [B, S, d] and [T, k]
    queues = _place(plan, 1)                      # [E, shards·cap, d]
    rep = _place(plan, None)
    router_grad = _place(plan, None, dp=_partial())
    buf, slot, keep, gate = _local_map(
        plan, lambda xl, rl: _moe_dispatch_local(xl, rl, m),
        (queues, tok, tok, tok), (tok, rep), (tok, router_grad))(
            x, lw["router"])
    h = F.silu(torch.bmm(buf, lw["moe_gate"])) * torch.bmm(buf, lw["moe_up"])
    out_buf = torch.bmm(h, lw["moe_down"]).redistribute(plan.mesh, queues)
    out = _local_map(
        plan, lambda ob, sl, kp, gv: _moe_combine_local(ob, sl, kp, gv,
                                                        x.dtype),
        tok, (queues, tok, tok, tok))(out_buf, slot, keep, gate)
    if m.n_shared:
        xf = x.reshape(B * S, d)
        shared = F.silu(torch.matmul(xf, lw["shared_gate"])) * torch.matmul(
            xf, lw["shared_up"])
        out = out + torch.matmul(shared, lw["shared_down"])
    return out.reshape(B, S, d)


def _partial():
    from torch.distributed.tensor import Partial

    return Partial()


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _rope_qk(cfg, plan, q, k, positions, start: int, sharded: bool):
    """RoPE on q and k; on a mesh under ``local_map``, with the positions
    (``start + arange(S)``, the rank's batch rows) made from the local
    shapes."""
    if plan.mesh is None:
        return (rope(q, positions, cfg.rope_theta),
                rope(k, positions, cfg.rope_theta))

    def local(ql, kl):
        B, S = ql.shape[:2]
        pos = (start + torch.arange(S, device=ql.device))[None].expand(B, S)
        return rope(ql, pos, cfg.rope_theta), rope(kl, pos, cfg.rope_theta)

    pl = _place(plan, 0, 2 if sharded else None)
    return _local_map(plan, local, (pl, pl), (pl, pl))(q, k)


def _attention(cfg, plan, q, k, v, causal_offset: int, sharded: bool):
    """``gqa_attention`` with its heads flattened, ``[B, S, H·dh]``; on a
    mesh under ``local_map`` on the rank's heads (all of them where not
    ``sharded``), K and V placed to match first. The flattening is local
    too: DTensor cannot split a dim of heads that ``"model"`` does not
    divide, which the backward of a flattening outside would ask."""
    B, S, H, dh = q.shape
    if plan.mesh is None:
        att = gqa_attention(q, k, v, causal_offset=causal_offset,
                            q_chunk=cfg.q_chunk)
        return plan.shard(att, "act_heads").reshape(B, S, H * dh)
    pl = _place(plan, 0, 2 if sharded else None)
    k, v = (t.redistribute(plan.mesh, pl) for t in (k, v))

    def local(ql, kl, vl):
        att = gqa_attention(ql, kl, vl, causal_offset=causal_offset,
                            q_chunk=cfg.q_chunk)
        return att.reshape(*att.shape[:2], -1)

    return _local_map(plan, local, pl, (pl, pl, pl))(q, k, v)


def _layer(cfg: TransformerConfig, plan: ShardingPlan, x, lw, positions,
           kv_cache=None, cache_len=None):
    """One transformer block. Returns (x, new_kv): new_kv is (k, v) of this
    call's tokens, or with ``kv_cache`` the layer's cache, into which this
    call's k/v were written at ``cache_len`` in place."""
    B, S, d = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    sharded = heads_sharded(cfg, plan)

    h = rms_norm(x, lw["attn_norm"], cfg.norm_eps)
    q = torch.matmul(h, lw["wq"])
    k = torch.matmul(h, lw["wk"])
    v = torch.matmul(h, lw["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = _heads(plan, q, H, dh, sharded)
    if sharded or plan.mesh is None:
        q = plan.shard(q, "act_heads")
    k = _heads(plan, k, Hkv, dh, sharded)
    v = _heads(plan, v, Hkv, dh, sharded)
    q, k = _rope_qk(cfg, plan, q, k, positions,
                    0 if cache_len is None else cache_len, sharded)

    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_len + S > ck.shape[1]:
            raise ValueError(f"decode: {S} new token(s) at cache_len "
                             f"{cache_len} do not fit a cache of "
                             f"{ck.shape[1]} slots")
        if plan.mesh is not None:      # the cache keeps its own placement
            k, v = (t.to(ck.dtype).redistribute(plan.mesh, ck.placements)
                    for t in (k, v))
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        att = _attention(cfg, plan, q, ck, cv, cache_len, sharded)
        new_kv = (ck, cv)
    else:
        att = _attention(cfg, plan, q, k, v, 0, sharded)
        new_kv = (k, v)

    x = x + torch.matmul(att, lw["wo"])
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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  plan: ShardingPlan = None):
    """Mean of ``logsumexp(logits) - logits[target]`` in float32. The gold
    logit is taken before its cast to float32 (the same value; its
    gradient is scattered in the activation dtype, as the reference's
    cast's is). On a mesh whose ``"model"`` axis splits the vocabulary,
    vocab-parallel (:class:`_VocabParallelCE`)."""
    plan = plan or null_plan()
    if plan.mesh is not None:
        return _cross_entropy_mesh(logits, targets, plan)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold.float())


def _token_loss(logits, targets):
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold.float()


def _all_reduce(t, op: str, group):
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


class _VocabParallelCE(torch.autograd.Function):
    """Each token's ``logsumexp - gold`` from this rank's vocabulary slice
    ``logits`` [..., V/tp] (its first id ``v0``): a local max and sum of
    exponentials and the gold logit where the target falls in the slice,
    each all-reduced over ``group``. The backward is local: ``softmax -
    onehot`` on the slice, in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets, v0: int, group):
        lf = logits.float()
        m = _all_reduce(lf.amax(dim=-1), "max", group)
        s = _all_reduce(torch.exp(lf - m[..., None]).sum(dim=-1), "sum",
                        group)
        logz = torch.log(s) + m
        t = targets.long() - v0
        inr = (t >= 0) & (t < logits.shape[-1])
        tc = torch.where(inr, t, 0)
        gold = torch.where(inr, torch.gather(logits, -1, tc[..., None])[
            ..., 0].float(), 0.0)
        gold = _all_reduce(gold, "sum", group)
        ctx.save_for_backward(logits, logz, tc, inr)
        return logz - gold

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        logits, logz, tc, inr = ctx.saved_tensors
        g = torch.exp(logits.float() - logz[..., None]) * grad[..., None]
        g.scatter_add_(-1, tc[..., None],
                       torch.where(inr, -grad, 0.0)[..., None])
        return g.to(logits.dtype), None, None, None


def _cross_entropy_mesh(logits, targets, plan):
    mesh = plan.mesh
    tp = plan.axis_size("model")
    tok = _place(plan, 0)
    if tp == 1:                        # nothing split: the plain loss
        loss = _local_map(plan, _token_loss, tok,
                          (_place(plan, 0, 2), tok))(logits, targets)
    else:
        dim = mesh.mesh_dim_names.index("model")
        step = -(-logits.shape[-1] // tp)          # chunk of a rank
        v0 = mesh.get_local_rank("model") * step

        def local(ll, tl):
            return _VocabParallelCE.apply(ll, tl, v0, (mesh, dim))

        loss = _local_map(plan, local, tok, (_place(plan, 0, 2), tok))(
            logits, targets)
    return torch.mean(loss)


def lm_loss(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            plan: ShardingPlan = None) -> torch.Tensor:
    """Next-token cross entropy (the train_step objective)."""
    logits = forward(cfg, params, tokens[:, :-1], plan)
    return cross_entropy(logits, tokens[:, 1:], plan)


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
