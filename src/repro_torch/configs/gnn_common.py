"""Shared GNN-family machinery: torch port of ``repro.configs.gnn_common``
(the four assigned shapes, the train step, the two losses, the smoke case
and the registration), less the dry-run case (``launch/``, ROADMAP A15).

Shapes (assigned): full_graph_sm (2708/10556/1433 — Cora-scale),
minibatch_lg (232965 nodes/114.6M edges, batch 1024 fanout 15-10 — the
*sampled padded subgraph*, from ``repro_torch.data.synthetic.
neighbor_sampled_batch``), ogb_products (2449029/61859140/100,
full-batch-large), molecule (30/64 × batch 128).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import ArchSpec, register
from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import GraphBatch, scatter_rows
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import value_and_grad

GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")

# minibatch_lg: padded sampled-subgraph sizes for batch=1024, fanout (15,10)
_MB_NODES = 1024 * (1 + 15 + 150)
_MB_EDGES = 1024 * (15 + 150)

SHAPE_DIMS = dict(
    full_graph_sm=dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                       task="node_class", n_classes=7),
    minibatch_lg=dict(n_nodes=_MB_NODES, n_edges=_MB_EDGES, d_feat=602,
                      task="node_class", n_classes=41,
                      note="padded 2-hop sample of the 232965-node graph"),
    ogb_products=dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                      task="node_class", n_classes=47),
    molecule=dict(n_nodes=30 * 128, n_edges=64 * 2 * 128, d_feat=16,
                  task="graph_reg", n_graphs=128),
)


def minibatch_lg_graph(device=None, n_vertices: int = 232_965,
                       batch_nodes: int = 1024, fanouts=(15, 10),
                       seed: int = 0):
    """``minibatch_lg`` as a GraphBatch on ``device`` (default: the CUDA
    card), without plans: the neighbour-sampled subgraph
    (``data.synthetic.neighbor_sampled_batch``, 602 features) of a seeded
    Barabási–Albert stand-in (m = 4, no isolated vertex) for the
    232,965-vertex graph. The sampler draws with replacement and gives
    each sampled neighbour a slot of its own, so the edges depend only on
    the fanouts: every slot is real. Also a seeded ``[E, 8]`` edge_feat
    and ``[N, 3]`` pos, and the 41-class labels ``argmax(node_feat[:,
    :41])`` (learnable, so a falling loss means something). Returns
    ``(graph, labels)``."""
    from repro_torch.data.synthetic import neighbor_sampled_batch
    from repro_torch.graphs.generators import barabasi_albert

    dims = SHAPE_DIMS["minibatch_lg"]
    device = resolve_device(device)
    n, rows, cols, _ = barabasi_albert(n_vertices, m=4, seed=seed)
    deg = np.bincount(rows, minlength=n)
    if deg.min() == 0:
        raise ValueError("minibatch_lg_graph: the stand-in graph has an "
                         "isolated vertex")
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = cols[np.argsort(rows, kind="stable")]
    b = neighbor_sampled_batch(indptr, indices, batch_nodes=batch_nodes,
                               fanouts=tuple(fanouts), seed=seed,
                               d_feat=dims["d_feat"])
    N, E = b["node_feat"].shape[0], b["senders"].shape[0]
    edge_feat = np.random.default_rng(seed + 2).normal(size=(E, 8))
    pos = np.random.default_rng(seed + 3).normal(size=(N, 3))
    labels = np.argmax(b["node_feat"][:, :dims["n_classes"]], axis=1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    g = GraphBatch(senders=t(b["senders"], torch.int32),
                   receivers=t(b["receivers"], torch.int32),
                   node_feat=t(b["node_feat"]), edge_feat=t(edge_feat),
                   pos=t(pos))
    return g, t(labels, torch.int32)


def gnn_train_step(forward_loss, opt_cfg: AdamWConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``: the loss and its gradients by autograd, then
    ``adamw_update``; functional, as the reference's."""
    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: forward_loss(p, batch),
                                     params)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, dict(loss=loss, **metrics)
    return step


def node_class_loss(logits, labels, n_real):
    """Cross entropy over real (non-padding) nodes."""
    n = logits.shape[0]
    mask = torch.arange(n, device=logits.device) < n_real
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.sum(torch.where(mask, logz - gold, 0)) / n_real


def graph_reg_loss(node_out, graph_id, targets, n_graphs, plan=None):
    """Mean squared error of each graph's summed ``node_out[:, 0]``; the
    sum is the scatter-sum kernel over ``graph_id``, ``plan`` its
    ``bag_grad_plan`` for ``n_graphs`` rows (built once a batch)."""
    pooled = scatter_rows(node_out[:, :1], graph_id, n_graphs, plan)[:, 0]
    return torch.mean(torch.square(pooled - targets))


def make_gnn_smoke_case(make_model, needs_pos=False, needs_edge_feat=False,
                        device=None, d_edge_in=8):
    """The reference's smoke case (N = 24, E = 60, DF = 12, its numpy
    draws; the weights from a seeded ``torch.Generator``): the forward's
    output, the loss ``mean(out²)`` and its gradients, on ``device``
    (default: the CUDA card)."""
    def run():
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        N, E, DF = 24, 60, 12
        cfg, init_fn, fwd = make_model("smoke", DF)
        params = init_fn(cfg, torch.Generator().manual_seed(0), dev)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        g = GraphBatch(
            senders=t(rng.integers(0, N, E), torch.int32),
            receivers=t(rng.integers(0, N, E), torch.int32),
            node_feat=t(rng.normal(size=(N, DF))),
            edge_feat=t(rng.normal(size=(E, d_edge_in)))
            if needs_edge_feat else None,
            pos=t(rng.normal(size=(N, 3))) if needs_pos else None,
        ).with_plans()

        def loss_fn(p):
            o = fwd(cfg, p, g)
            o = o[0] if isinstance(o, tuple) else o
            return torch.mean(torch.square(o))

        with torch.no_grad():
            out = fwd(cfg, params, g)
        out = out[0] if isinstance(out, tuple) else out
        loss, grads = value_and_grad(loss_fn, params)
        return dict(loss=loss, out=out, grads=grads)
    return run


def register_gnn(arch_id, make_model, needs_pos=False, needs_edge_feat=False,
                 describe=""):
    return register(ArchSpec(
        arch_id=arch_id, family="gnn", shapes=GNN_SHAPES,
        make_smoke_case=lambda device=None: make_gnn_smoke_case(
            make_model, needs_pos, needs_edge_feat, device=device),
        describe=describe))
