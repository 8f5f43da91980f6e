"""EquiformerV2-style equivariant graph attention via eSCN convolutions
(Liao et al., arXiv:2306.12059; eSCN trick from Passaro & Zitnick,
arXiv:2302.03655); torch port of ``repro.models.gnn.equiformer``.
Assigned config: 12 layers, d_hidden=128 channels, l_max=6, m_max=2, 8
heads.

Structure per layer, as the reference's:

  1. per edge: rotate source irreps features into the edge-aligned frame
     (Wigner blocks from ``so3.wigner_from_rotation``, computed once per
     forward with no gradient and shared by every layer),
  2. truncate to |m| ≤ m_max (the eSCN reduction),
  3. SO(2) convolution: per-m complex-structured channel mixing,
     conditioned on the edge distance embedding,
  4. attention: invariant (m=0) channel → per-head logits → edge softmax
     over each receiver's edges (``sparse.segment.segment_softmax``),
  5. rotate messages back (Dᵀ), scatter-sum to receivers,
  6. node update: per-degree RMS norm + l=0-gated nonlinearity + pointwise
     channel mixing.

Message passing runs on the embedding-bag kernels (``common.gather_rows``
/ ``scatter_rows``) with rows of (l_max+1)²·C floats, over plans built
once a graph (``GraphBatch.with_plans(edge_chunk=...)``: the endpoints'
and each edge chunk's); each chunk's scatter adds into the running sum of
the chunks before it (the kernel's accumulate form, ``ScatterAdd``), so a
chunk makes no ``[N, (l_max+1)²·C]`` result of its own. The layout is
planned for memory, so that
``FULL`` trains on ``minibatch_lg`` on one card; the values are the
reference's up to float32 rounding:

* Only the |m| ≤ m_max coefficients of the rotated sources are formed,
  by one batched product with the rows of D they need (``[E, T, K]``,
  T = 29 of K = 49 at ``FULL``), kept in m-major order so that each
  m-group's operand is a view; the rotation back is the transposed
  product. The rotations save only D for the backward (``_Rotate``).
* The m > 0 products run as one product with the real block form
  ``[[W_r, W_i], [−W_i, W_r]]``; each head's softmax weight is folded into
  the distance embedding that scales every message.
* The degree norm divides by an ``[N, K, 1]`` scale and the gated residual
  scales ``upd`` degree by degree in place (``_GatedResidual``): neither
  concatenates ``[N, K, C]`` copies.
* The first layer takes the node embedding ``[N, C]`` and builds its
  irreps itself, so that under remat its saved input is ``[N, C]``; the
  readout normalises only degree 0.
* Edge chunks are edge ranges ``[c·chunk, (c+1)·chunk)``; the last one is
  not padded (the reference pads with sentinel edges, whose messages are
  dropped), and ``agg`` is the chunks' scatters summed in chunk order.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import (GraphBatch, chunk_plans,
                                           edge_chunks, gather_rows, init_mlp,
                                           mlp_apply, rbf_encode,
                                           reduce_edges, scatter_rows)
from repro_torch.models.gnn.so3 import (frame_from_direction, n_coeffs,
                                        pack_wigner, wigner_from_rotation)
from repro_torch.sparse.segment import segment_softmax, take_fill


@dataclasses.dataclass(frozen=True)
class EquiformerConfig:
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_node_in: int = 16
    n_rbf: int = 16
    d_out: int = 1
    # Big-graph controls: ``edge_chunk_size`` streams the edges' message
    # tensors chunk by chunk (bounding the [chunk, (L+1)², C] working set);
    # ``remat`` recomputes each layer on the backward pass
    # (torch.utils.checkpoint).
    edge_chunk_size: int | None = None
    remat: bool = False
    reuse_wigner: bool = True   # D once per forward vs once per layer


def _m_structure(l_max: int, m_max: int):
    """For each m in [0, m_max]: list of degrees l >= m. m=0 is real; m>0
    carries (cos, sin) pairs."""
    return {m: [l for l in range(m, l_max + 1)] for m in range(m_max + 1)}


def init_equiformer(cfg: EquiformerConfig, generator: torch.Generator,
                    device=None) -> dict:
    """The reference's parameter tree, drawn from ``generator`` (see
    ``init_mlp``) onto ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    C, H = cfg.channels, cfg.n_heads

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(device)

    p = dict(embed=init_mlp([cfg.d_node_in, C], generator, device),
             readout=init_mlp([C, C, cfg.d_out], generator, device),
             layers=[])
    for _ in range(cfg.n_layers):
        lp = dict(dist_mlp=init_mlp([cfg.n_rbf, C, C], generator, device),
                  attn_mlp=init_mlp([2 * C, C, H], generator, device),
                  out_proj=normal((C, C), 1.0 / math.sqrt(C)),
                  gate=init_mlp([C, C * cfg.l_max], generator, device),
                  so2={})
        for m, ls in _m_structure(cfg.l_max, cfg.m_max).items():
            scale = 1.0 / math.sqrt(len(ls) * C)
            lp["so2"][f"m{m}_r"] = normal((len(ls) * C, len(ls) * C), scale)
            if m > 0:
                lp["so2"][f"m{m}_i"] = normal((len(ls) * C, len(ls) * C),
                                              scale)
        p["layers"].append(lp)
    return p


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where the truncated coefficients go. ``groups``: the row range of
    each m-group in the m-major order (m = 0: l = 0..L; m > 0: the cos
    rows (l, m), then the sin rows (l, −m), l = m..L); ``rot_index`` [T·K]:
    for each truncated row and full column, its entry of the packed
    Wigner blocks, or the appended zero entry where the column is of
    another degree; ``block_sizes``: 2l+1 for each l."""

    n_trunc: int
    groups: tuple
    rot_index: tuple
    block_sizes: tuple


@lru_cache(maxsize=None)
def _layout(l_max: int, m_max: int) -> _Layout:
    K = n_coeffs(l_max)
    rows, groups = [], []
    for m, ls in _m_structure(l_max, m_max).items():
        start = len(rows)
        rows += [(l, m) for l in ls]
        if m > 0:
            rows += [(l, -m) for l in ls]
        groups.append((start, len(rows)))
    offsets = [sum((2 * k + 1) ** 2 for k in range(l))
               for l in range(l_max + 2)]
    zero = offsets[-1]
    index = []
    for l, m in rows:
        for col in range(K):
            b = col - l * l
            index.append(offsets[l] + (l + m) * (2 * l + 1) + b
                         if 0 <= b < 2 * l + 1 else zero)
    return _Layout(len(rows), tuple(groups), tuple(index),
                   tuple(2 * l + 1 for l in range(l_max + 1)))


def edge_rotation(cfg: EquiformerConfig, dirs: torch.Tensor) -> torch.Tensor:
    """``[E, T, K]``: for each edge, the rows of its block-diagonal Wigner
    matrix D(R), R = ``frame_from_direction(dirs)``, at the |m| ≤ m_max
    coefficients in m-major order (zero outside each row's degree), with
    no gradient: ``rot @ src`` is the truncation of ``rotate_coeffs(src,
    D)`` and ``rotᵀ @ msg`` is ``rotate_coeffs(msg, D, transpose=True)``
    for ``msg`` zero outside those coefficients."""
    lay = _layout(cfg.l_max, cfg.m_max)
    with torch.no_grad():
        packed = pack_wigner(wigner_from_rotation(frame_from_direction(dirs),
                                                  cfg.l_max))
        packed = torch.cat([packed, packed.new_zeros(packed.shape[0], 1)], 1)
        return packed[:, _rot_index(cfg.l_max, cfg.m_max, dirs.device)].view(
            -1, lay.n_trunc, n_coeffs(cfg.l_max))


@lru_cache(maxsize=None)
def _rot_index(l_max: int, m_max: int, device: torch.device) -> torch.Tensor:
    """``_layout(l_max, m_max).rot_index`` as a tensor on ``device``, made
    once per device (a real tensor, also where a dry-run's fake mode runs
    the first call)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return torch.tensor(_layout(l_max, m_max).rot_index, device=device)


class _Rotate(torch.autograd.Function):
    """``rot @ x`` (or ``rotᵀ @ x`` with ``transpose``) per edge, for ``rot``
    [E, T, K] without a gradient: saves ``rot`` only, so no rotated copy of
    the features is kept for the backward."""

    @staticmethod
    def forward(ctx, x, rot, transpose: bool):
        ctx.save_for_backward(rot)
        ctx.transpose = transpose
        return torch.bmm(rot.transpose(1, 2) if transpose else rot, x)

    @staticmethod
    def backward(ctx, g):
        (rot,) = ctx.saved_tensors
        return (torch.bmm(rot if ctx.transpose else rot.transpose(1, 2), g),
                None, None)


class _GatedResidual(torch.autograd.Function):
    """``x + upd · s`` for x, upd [N, K, C] and gates [N, L, C]: s is 1 on
    degree 0 and ``gates[:, l-1]`` on the 2l+1 coefficients of degree l
    (the reference's concatenated scale, applied block by block in place).
    Saves ``upd`` and ``gates``."""

    @staticmethod
    def forward(ctx, x, upd, gates, block_sizes: tuple):
        ctx.save_for_backward(upd, gates)
        ctx.block_sizes = block_sizes
        out = upd.clone()
        lo = block_sizes[0]
        for l, n in enumerate(block_sizes[1:], start=1):
            out[:, lo:lo + n].mul_(gates[:, l - 1:l])
            lo += n
        return out.add_(x)

    @staticmethod
    def backward(ctx, g):
        upd, gates = ctx.saved_tensors
        g_upd = g.clone()
        g_gates = []
        lo = ctx.block_sizes[0]
        for l, n in enumerate(ctx.block_sizes[1:], start=1):
            g_gates.append(torch.sum(g[:, lo:lo + n] * upd[:, lo:lo + n], 1))
            g_upd[:, lo:lo + n].mul_(gates[:, l - 1:l])
            lo += n
        return g, g_upd, torch.stack(g_gates, 1), None


def _so2_weights(lp: dict, m_max: int) -> list:
    """Each m-group's mixing matrix: ``W_0`` for m = 0, and for m > 0 the
    real form ``[[W_r, W_i], [−W_i, W_r]]`` of the complex product, so that
    ``[f_c | f_s] @ W = [f_c W_r − f_s W_i | f_c W_i + f_s W_r]``."""
    so2 = lp["so2"]
    out = [so2["m0_r"]]
    for m in range(1, m_max + 1):
        wr, wi = so2[f"m{m}_r"], so2[f"m{m}_i"]
        out.append(torch.cat([torch.cat([wr, wi], 1),
                              torch.cat([-wi, wr], 1)], 0))
    return out


def _degree_norm(cfg, x):
    """Per-degree RMS normalisation of irreps features [N, (L+1)², C]."""
    N, K, C = x.shape
    # Σ_c x² as a norm squared: one reduction pass, no [N, K, C] temporary
    # (a batched dot product runs as N·K one-column products)
    sq = torch.square(torch.linalg.vector_norm(x, dim=-1))
    sizes = _layout(cfg.l_max, cfg.m_max).block_sizes
    ms = torch.stack([b.sum(1) / (n * C) for b, n in
                      zip(torch.split(sq, sizes, dim=1), sizes)], 1)
    rms = torch.sqrt(ms + 1e-6)
    per_coeff = torch.cat([rms[:, l:l + 1].expand(N, n)
                           for l, n in enumerate(sizes)], 1)   # [N, K]
    return x / per_coeff[..., None]


def _degree0_norm(x0):
    """``_degree_norm(x)[:, 0, :]`` from ``x0 = x[:, 0, :]``."""
    return x0 / torch.sqrt(torch.mean(torch.square(x0), 1, keepdim=True)
                           + 1e-6)


def _irreps(emb, K):
    """``[N, K, C]`` zeros with degree 0 set to ``emb`` [N, C]."""
    return torch.cat([emb[:, None, :], emb.new_zeros(
        (emb.shape[0], K - 1, emb.shape[1]))], 1)


def _so2_conv(cfg, lp, t, scale):
    """t [E, T, C], the edge-frame |m| ≤ m_max coefficients in m-major
    order -> the messages there, each m-group mixed over (l, channel) and
    every row scaled by ``scale`` [E, C]."""
    E, _, C = t.shape
    outs = []
    for (a, b), w in zip(_layout(cfg.l_max, cfg.m_max).groups,
                         _so2_weights(lp, cfg.m_max)):
        o = (t[:, a:b].reshape(E, (b - a) * C) @ w).view(E, b - a, C)
        outs.append(o * scale[:, None, :])
    return torch.cat(outs, 1)


def _edge_messages(cfg, lp, h, senders, receivers, rot, scale, plans,
                   acc=None):
    """Messages of one edge set (all edges or a chunk), summed at their
    receivers: ``[N, K·C]``, added into ``acc`` in place where one is
    given (the sum of earlier chunks). ``rot`` is the edges'
    :func:`edge_rotation`, ``scale`` [E, C] each edge's distance embedding
    times its heads' softmax weights, ``plans`` the bag plans of
    ``senders`` and ``receivers``. Under ``edge_parallel`` the sum is this
    rank's partial: the caller reduces it."""
    N, K, C = h.shape
    E = senders.shape[0]
    src = gather_rows(h.view(N, K * C), senders, plans[0]).view(E, K, C)
    msg = _so2_conv(cfg, lp, _Rotate.apply(src, rot, False), scale)
    msg = _Rotate.apply(msg, rot, True)
    return scatter_rows(msg.view(E, K * C), receivers, N, plans[1], acc=acc,
                        reduce=False)


@dataclasses.dataclass
class _Edges:
    """Per-forward edge state, shared by every layer: ``rbf`` [E, n_rbf],
    ``valid`` (geo_valid), ``dirs``, the chunks' edge ranges, their bag
    plans ``(senders', receivers')`` and, with ``reuse_wigner``, their
    :func:`edge_rotation`."""

    rbf: torch.Tensor
    valid: torch.Tensor
    dirs: torch.Tensor
    chunks: list
    plans: list
    rot: list | None


def _edges(cfg: EquiformerConfig, g: GraphBatch) -> _Edges:
    xi = take_fill(g.pos, g.receivers, 0)
    xj = take_fill(g.pos, g.senders, 1)
    diff = xi - xj
    dist = torch.linalg.vector_norm(diff, dim=-1)
    dirs = diff / torch.clamp(dist[:, None], min=1e-9)
    # degenerate edges (self-loops / coincident endpoints) have no
    # direction: their frame would not co-rotate with the graph, so they
    # send no message
    valid = g.edge_valid & (dist > 1e-9) & (g.senders != g.receivers)
    chunk = cfg.edge_chunk_size
    if chunk is not None and g.n_edges > chunk:
        chunks = edge_chunks(g.n_edges, chunk)
        plans = (g.chunk_plans if g.edge_chunk == chunk
                 else chunk_plans(g, chunk))
    else:
        chunks = [(0, g.n_edges)]
        plans = [(g.sender_plan, g.receiver_plan)]
    rot = ([edge_rotation(cfg, dirs[a:b]) for a, b in chunks]
           if cfg.reuse_wigner else None)
    return _Edges(rbf_encode(dist, cfg.n_rbf), valid, dirs, chunks,
                  list(plans), rot)


def _layer(cfg, lp, x, g, edges, shard):
    K, C, H = n_coeffs(cfg.l_max), cfg.channels, cfg.n_heads
    if x.dim() == 2:                # the first layer: x is the embedding
        x = shard(_irreps(x, K))
    N = x.shape[0]
    h = shard(_degree_norm(cfg, x))
    # attention logits from invariants only, over all edges at once
    h0 = h[:, 0, :]
    inv_src = gather_rows(h0, g.senders, g.sender_plan)
    inv_dst = gather_rows(h0, g.receivers, g.receiver_plan)
    dist_emb = mlp_apply(lp["dist_mlp"], edges.rbf, final_act=True)
    logits = mlp_apply(lp["attn_mlp"],
                       torch.cat([inv_src * dist_emb, inv_dst], -1))
    alpha = segment_softmax(logits, g.receivers, N, valid=edges.valid,
                            plan=g.receiver_plan)               # [E, H]
    scale = dist_emb * alpha.repeat_interleave(C // H, dim=1)
    # each chunk's messages added into the running sum by the scatter
    # itself (the reference's scan carries agg + _edge_messages(...))
    agg = None
    for i, (a, b) in enumerate(edges.chunks):
        rot = (edges.rot[i] if edges.rot is not None
               else edge_rotation(cfg, edges.dirs[a:b]))
        agg = _edge_messages(cfg, lp, h, g.senders[a:b], g.receivers[a:b],
                             rot, scale[a:b], edges.plans[i], agg)
    agg = shard(reduce_edges(agg).view(N, K, C))
    del h, h0
    # node update: gated nonlinearity + channel mixing
    upd = (agg.view(N * K, C) @ lp["out_proj"]).view(N, K, C)
    gates = torch.sigmoid(mlp_apply(lp["gate"], upd[:, 0, :]))
    return shard(_GatedResidual.apply(
        x, upd, gates.view(N, cfg.l_max, C),
        _layout(cfg.l_max, cfg.m_max).block_sizes))


def equiformer_forward(cfg: EquiformerConfig, params: dict, g: GraphBatch,
                       node_shard=None):
    """g.pos required. Returns invariant node outputs [N, d_out].

    ``node_shard``: optional callable applied to the [N, (L+1)², C] irreps
    tensors, as the reference's sharding hook (None: identity)."""
    shard = node_shard or (lambda t: t)
    edges = _edges(cfg, g)

    def layer(x, lp):
        return _layer(cfg, lp, x, g, edges, shard)

    x = mlp_apply(params["embed"], g.node_feat)     # the first layer's input
    for lp in params["layers"]:
        if cfg.remat:
            x = checkpoint(layer, x, lp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x, lp)
    # degree 0 alone, copied, so that nothing keeps the last [N, K, C] alive
    x0 = x if x.dim() == 2 else x[:, 0, :].clone()
    del x
    return mlp_apply(params["readout"], _degree0_norm(x0))
