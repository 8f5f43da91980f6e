"""Of ``repro.models.gnn.common``: the ``GraphBatch`` container, message
passing (``gather_src``, ``gather_dst``, ``scatter_sum``,
``segment_mean_max``), the tiny MLP substrate (``init_mlp``,
``mlp_apply``) and ``rbf_encode``, as plain functions over tensors and a
``{"w": [...], "b": [...]}`` dict. Weights keep the reference's ``[in,
out]`` layout, so ``x @ w + b``. The products go to ``torch.matmul``, as
the JAX package leaves them to XLA.

Message passing is the reference's gather at edge endpoints and sum at
receivers, on the embedding-bag kernels with bags of one id
(``kernels.embedding_bag``): a gather is the bag forward, its gradient
the bag backward; a scatter-sum is the bag backward, its gradient the bag
forward. Both are deterministic (sorted, no float atomics), so a training
step gives the same bits every time. The backward kernel reads a
``bag_grad_plan`` (the ids sorted once): :meth:`GraphBatch.with_plans`
builds the senders' and the receivers' once per graph, and every layer
and step then shares them.

Edge-parallel (the dry-run's rank program, ``configs.gnn_common``): under
:func:`edge_parallel` the edges are this rank's share and the node states
are replicated, so each scatter-sum (and :func:`edge_max`) of edge
messages is a partial that is all-reduced over the group (its backward the
identity; a sum over several edge chunks is reduced once, by
:func:`reduce_edges`), and each gather of a node state that carries a gradient
all-reduces that gradient on the way back (the forward the identity): the
two conjugate collectives of tensor-parallel layers. Scatters over other
ids (a graph's nodes) take :func:`edge_parallel` ``(None)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import BagGradPlan, bag_grad_plan
from repro_torch.sparse.segment import segment_max


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded graph (or batch of graphs flattened into one), as tensors on
    one device.

    ``senders``/``receivers``: [E] int32, sentinel = n_nodes for padding.
    ``node_feat``: [N, d]; optional positions [N, 3] and edge feats [E, de].
    ``sender_plan``/``receiver_plan``: the ``bag_grad_plan`` of each
    endpoint array for ``n_nodes`` rows (:meth:`with_plans`); without
    them every gather's and scatter's backward sorts its ids anew.
    ``chunk_plans``: with ``edge_chunk`` set, the ``(senders',
    receivers')`` plans of each chunk of :func:`edge_chunks` (Equiformer-v2
    streams its edges in such chunks).
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    node_feat: torch.Tensor
    edge_feat: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    graph_id: Optional[torch.Tensor] = None   # [N] for batched small graphs
    sender_plan: Optional[BagGradPlan] = None
    receiver_plan: Optional[BagGradPlan] = None
    edge_chunk: Optional[int] = None
    chunk_plans: Optional[tuple] = None

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def edge_valid(self) -> torch.Tensor:
        return self.senders < self.n_nodes

    def with_plans(self, edge_chunk: Optional[int] = None) -> "GraphBatch":
        """This batch with both endpoint arrays' plans built, one each;
        with ``edge_chunk``, also each edge chunk's two (none where the
        edges fit one chunk)."""
        n = self.n_nodes
        chunks = (chunk_plans(self, edge_chunk)
                  if edge_chunk is not None and self.n_edges > edge_chunk
                  else None)
        return dataclasses.replace(
            self, sender_plan=bag_grad_plan(self.senders.reshape(-1, 1), n),
            receiver_plan=bag_grad_plan(self.receivers.reshape(-1, 1), n),
            edge_chunk=edge_chunk, chunk_plans=chunks)


def edge_chunks(n_edges: int, chunk: Optional[int]) -> list:
    """The edge ranges ``[(start, stop)]`` of ``chunk`` edges each (the
    last one shorter); one range where ``chunk`` is None or not below
    ``n_edges``."""
    if chunk is None or n_edges <= chunk:
        return [(0, n_edges)]
    return [(a, min(a + chunk, n_edges)) for a in range(0, n_edges, chunk)]


def chunk_plans(g: GraphBatch, chunk: int) -> tuple:
    """``((senders' plan, receivers' plan), ...)``, one pair for each edge
    range of ``edge_chunks(g.n_edges, chunk)``, for ``g.n_nodes`` rows."""
    n = g.n_nodes
    return tuple((bag_grad_plan(g.senders[a:b].reshape(-1, 1), n),
                  bag_grad_plan(g.receivers[a:b].reshape(-1, 1), n))
                 for a, b in edge_chunks(g.n_edges, chunk))


_EDGE_GROUP: list = [None]


@contextlib.contextmanager
def edge_parallel(group):
    """Message passing over this rank's share of the edges for the block:
    ``group`` is the process group the edges are split over (None: every
    edge is here)."""
    _EDGE_GROUP.append(group)
    try:
        yield
    finally:
        _EDGE_GROUP.pop()


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op, group))


class _ReduceFromEdges(torch.autograd.Function):
    """The all-reduce of a partial over the edge split; the gradient of a
    sum passes as it is, that of a max or min to the entries that were
    the group's extreme."""

    @staticmethod
    def forward(ctx, t, op, group):
        out = _all_reduce(t, op, group)
        ctx.op = op
        if op != "sum":
            ctx.save_for_backward(t == out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None
        (hit,) = ctx.saved_tensors
        return torch.where(hit, g, 0), None, None


class _CopyToEdges(torch.autograd.Function):
    """A replicated node state read by this rank's edges: the identity,
    whose gradient (a partial over the edge split) is all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


def edge_max(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``sparse.segment.segment_max`` of edge data over ``n`` nodes, all
    the group's edges under :func:`edge_parallel`."""
    out = segment_max(data, ids, n)
    group = _EDGE_GROUP[-1]
    return out if group is None else _ReduceFromEdges.apply(out, "max",
                                                            group)


def edge_min(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`edge_max` for ``segment_min``."""
    from repro_torch.sparse.segment import segment_min

    out = segment_min(data, ids, n)
    group = _EDGE_GROUP[-1]
    return out if group is None else _ReduceFromEdges.apply(out, "min",
                                                            group)


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                plan: Optional[BagGradPlan] = None) -> torch.Tensor:
    """``x[idx]`` along dim 0 for ``x`` [n, d] and ``idx`` [E] int32, rows
    of ids outside ``[0, n)`` 0 (``jnp.take(mode="fill", fill_value=0)``):
    the bag forward kernel, differentiable through ``BagSum`` over
    ``plan`` (the ``bag_grad_plan`` of ``idx`` for ``n`` rows)."""
    from repro_torch.kernels.embedding_bag import BagSum, embedding_bag_kernel

    bags = idx.reshape(-1, 1)
    x = x.contiguous()
    if x.requires_grad and torch.is_grad_enabled():
        if _EDGE_GROUP[-1] is not None:
            x = _CopyToEdges.apply(x, _EDGE_GROUP[-1])
        return BagSum.apply(x, bags, plan)
    return embedding_bag_kernel(x, bags)


def scatter_rows(msgs: torch.Tensor, idx: torch.Tensor, n: int,
                 plan: Optional[BagGradPlan] = None,
                 acc: Optional[torch.Tensor] = None,
                 reduce: bool = True) -> torch.Tensor:
    """``segment_sum(msgs, idx, n)`` for ``msgs`` [E, d] and ``idx`` [E]
    int32, ids outside ``[0, n)`` dropped: the bag backward kernel over
    ``plan`` (the ``bag_grad_plan`` of ``idx`` for ``n`` rows),
    differentiable through ``ScatterSum``. With ``acc`` ([n, d] float32,
    e.g. the sum of earlier edge chunks' messages) the sums are added into
    ``acc`` in place and ``acc`` is returned (the kernel's accumulate
    form, through ``ScatterAdd``, with no ``[n, d]`` result of its own;
    from d = 32 on the bits of ``acc.add_(scatter_rows(msgs, ...))``).

    Under :func:`edge_parallel` the result is all-reduced over the group
    (all of it, ``acc`` included), unless ``reduce`` is False: a caller
    that sums several edge sets passes False to each and reduces the
    total once with :func:`reduce_edges`."""
    from repro_torch.kernels.embedding_bag import (ScatterAdd, ScatterSum,
                                                   embedding_bag_backward)

    bags = idx.reshape(-1, 1)
    grad = torch.is_grad_enabled() and (
        msgs.requires_grad or (acc is not None and acc.requires_grad))
    if acc is not None:
        out = (ScatterAdd.apply(acc, msgs, bags, n, plan) if grad else
               embedding_bag_backward(msgs.contiguous(), bags, n, plan,
                                      acc=acc))
    elif grad:
        out = ScatterSum.apply(msgs, bags, n, plan)
    else:
        out = embedding_bag_backward(msgs.contiguous(), bags, n, plan)
    return reduce_edges(out) if reduce else out


def reduce_edges(t: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's edges all-reduced over the
    :func:`edge_parallel` group (its gradient passes as it is); ``t``
    itself where every edge is here."""
    group = _EDGE_GROUP[-1]
    return t if group is None else _ReduceFromEdges.apply(t, "sum", group)


def gather_src(g: GraphBatch, x: torch.Tensor) -> torch.Tensor:
    return gather_rows(x, g.senders, g.sender_plan)


def gather_dst(g: GraphBatch, x: torch.Tensor) -> torch.Tensor:
    return gather_rows(x, g.receivers, g.receiver_plan)


def scatter_sum(g: GraphBatch, msgs: torch.Tensor) -> torch.Tensor:
    """Σ of each node's incoming messages; a message whose sender is
    padding (``edge_valid`` false) counts 0, as in the reference."""
    m = torch.where(g.edge_valid[:, None], msgs, 0)
    return scatter_rows(m, g.receivers, g.n_nodes, g.receiver_plan)


def in_degrees(g: GraphBatch, dtype=torch.float32) -> torch.Tensor:
    """[N, 1]: each node's count of valid incoming edges."""
    return scatter_sum(g, torch.ones((g.n_edges, 1), dtype=dtype,
                                     device=g.senders.device))


def segment_mean_max(g: GraphBatch, msgs: torch.Tensor):
    """``(mean, max, count)`` of each node's valid incoming messages; nodes
    with none get 0 for both."""
    valid = g.edge_valid[:, None]
    s = scatter_sum(g, msgs)
    cnt = in_degrees(g, msgs.dtype)
    mean = s / torch.clamp(cnt, min=1)
    neg = torch.finfo(msgs.dtype).min
    mx = edge_max(torch.where(valid, msgs, neg), g.receivers, g.n_nodes)
    mx = torch.where(cnt > 0, mx, 0)
    return mean, mx, cnt


# ----------------------------------------------------------------------------
# tiny MLP substrate (framework-free)
# ----------------------------------------------------------------------------

def init_mlp(sizes, generator: torch.Generator, device=None,
             layernorm_out: bool = False) -> dict:
    """float32 weights ``N(0, 1/fan_in)`` of shape ``[sizes[i],
    sizes[i+1]]`` and zero biases; with ``layernorm_out`` a LayerNorm's
    unit ``ln_scale`` and zero ``ln_bias`` after the last layer. The draws
    come from ``generator`` on its own device and are then moved to
    ``device`` (default: the CUDA card), so the weights do not depend on
    where they are used."""
    device = resolve_device(device)
    params = {"w": [], "b": []}
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        params["w"].append(w.to(device))
        params["b"].append(torch.zeros(fan_out, device=device))
    if layernorm_out:
        params["ln_scale"] = torch.ones(sizes[-1], device=device)
        params["ln_bias"] = torch.zeros(sizes[-1], device=device)
    return params


def mlp_apply(params: dict, x: torch.Tensor, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    if "ln_scale" in params:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + 1e-6)
        x = x * params["ln_scale"] + params["ln_bias"]
    return x


def rbf_encode(dist: torch.Tensor, n_basis: int = 16,
               r_max: float = 5.0) -> torch.Tensor:
    """Gaussian radial basis (SchNet-style) for edge distances."""
    centers = torch.linspace(0.0, r_max, n_basis, dtype=dist.dtype,
                             device=dist.device)
    gamma = n_basis / r_max
    return torch.exp(-gamma * torch.square(dist[..., None] - centers))
