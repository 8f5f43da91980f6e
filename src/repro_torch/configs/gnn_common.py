"""Shared GNN-family machinery: torch port of ``repro.configs.gnn_common``
(the four assigned shapes, the train step, the two losses, the dry-run
case, the smoke case and the registration).

Distribution (the dry-run): message passing is the paper's semiring SpMV.
Edge arrays (the O(E) objects) are split over every mesh axis and node
state (O(n)) is replicated, the split the solver uses for its transfer
operators. The step is one rank's program: its share of the edges, under
``models.gnn.common.edge_parallel``, whose scatter-sums give partial node
sums that are all-reduced.

Shapes (assigned): full_graph_sm (2708/10556/1433 — Cora-scale),
minibatch_lg (232965 nodes/114.6M edges, batch 1024 fanout 15-10 — the
*sampled padded subgraph*, from ``repro_torch.data.synthetic.
neighbor_sampled_batch``), ogb_products (2449029/61859140/100,
full-batch-large), molecule (30/64 × batch 128).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import (ArchSpec, DryrunCase, TensorSpec,
                                          register)
from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import (GraphBatch, edge_parallel,
                                           scatter_rows)
from repro_torch.models.sharding import NamedSharding, P
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_map, value_and_grad

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


def gnn_train_step(forward_loss, opt_cfg: AdamWConfig, donate: bool = False,
                   grad_hook=None):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``: the loss and its gradients by autograd, then
    ``adamw_update``; functional, as the reference's (with ``donate``,
    AdamW writes into the given trees). ``grad_hook(grads) -> grads`` runs
    between the two where given."""
    def step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: forward_loss(p, batch),
                                     params)
        if grad_hook is not None:
            grads = grad_hook(grads)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state, donate=donate)
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
    with edge_parallel(None):            # the nodes are all here
        pooled = scatter_rows(node_out[:, :1], graph_id, n_graphs, plan)[:, 0]
    return torch.mean(torch.square(pooled - targets))


def init_shapes(init_fn, cfg) -> dict:
    """``init_fn(cfg, ...)``'s parameter tree as :class:`TensorSpec`
    leaves, traced on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_fn(cfg, torch.Generator(), "cpu")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), params)


def _local(tree):
    """A tree's DTensor leaves as this rank's local tensors."""
    return tree_map(lambda t: t.to_local() if hasattr(t, "to_local") else t,
                    tree)


def _rank_index_arrays(batch: dict, fake_mode, n_graphs=None,
                       edge_chunk=None, seed: int = 0) -> dict:
    """Real index arrays for this rank's share of the edges (uniform ids
    in ``[0, N)``, seeded, on the batch's device) in place of the fake
    ones, and the ``bag_grad_plan``s they need, built outside the fake
    mode (a plan is a sort of its ids), then entered into it."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.kernels.embedding_bag import BagGradPlan, bag_grad_plan

    senders = batch["senders"]
    E, N = senders.to_local().shape[0], batch["node_feat"].shape[0]
    dev = senders.device
    with unset_fake_temporarily():
        gen = torch.Generator().manual_seed(seed)
        ids = [torch.randint(0, N, (E,), generator=gen,
                             dtype=torch.int32).to(dev) for _ in range(2)]
        g = GraphBatch(senders=ids[0], receivers=ids[1],
                       node_feat=torch.empty((N, 0), device=dev)
                       ).with_plans(edge_chunk)
        extra = {}
        if n_graphs is not None:
            gid = (torch.arange(N) * n_graphs // N).to(torch.int32).to(dev)
            extra = dict(graph_id=gid, graph_plan=bag_grad_plan(
                gid.reshape(-1, 1), n_graphs))

    def fake(x):
        if isinstance(x, BagGradPlan):
            return BagGradPlan(fake_mode.from_tensor(x.sorted_ids),
                               fake_mode.from_tensor(x.rows), x.n_vocab,
                               x.hot)
        if isinstance(x, tuple):
            return tuple(fake(y) for y in x)
        return None if x is None else fake_mode.from_tensor(x)

    out = dict(senders=fake(g.senders), receivers=fake(g.receivers),
               plans=(fake(g.sender_plan), fake(g.receiver_plan)),
               edge_chunk=g.edge_chunk, chunk_plans=fake(g.chunk_plans))
    out.update({k: fake(v) for k, v in extra.items()})
    return out


def make_gnn_dryrun_case(arch_id, shape_name, mesh, make_model, flops_fn,
                         needs_pos=False, needs_edge_feat=False,
                         d_edge_in=8):
    """The reference's GNN dry-run case on ``mesh``: a train step on the
    shape's graph, the edges split over every mesh axis (E padded to a
    multiple of 512, the padding edges inert), node state, labels and
    parameters replicated; the state donated. The step runs as one rank's
    program under ``edge_parallel`` over the world group, on real index
    arrays of its share (``_rank_index_arrays``), with every weight's
    gradient all-reduced before AdamW."""
    import torch.distributed as dist

    dims = SHAPE_DIMS[shape_name]
    N, E, DF = dims["n_nodes"], dims["n_edges"], dims["d_feat"]
    E = -(-E // 512) * 512
    cfg, init_fn, fwd = make_model(shape_name, DF)
    pshapes = init_shapes(init_fn, cfg)
    rep = NamedSharding(mesh, P())
    axes = tuple(mesh.mesh_dim_names)
    edge_sh = NamedSharding(mesh, P(axes))
    params_sh = tree_map(lambda _: rep, pshapes)
    f32, i32 = torch.float32, torch.int32

    batch = dict(senders=TensorSpec((E,), i32),
                 receivers=TensorSpec((E,), i32),
                 node_feat=TensorSpec((N, DF), f32))
    batch_sh = dict(senders=edge_sh, receivers=edge_sh, node_feat=rep)
    if needs_edge_feat:
        batch["edge_feat"] = TensorSpec((E, d_edge_in), f32)
        batch_sh["edge_feat"] = NamedSharding(mesh, P(axes, None))
    if needs_pos:
        batch["pos"] = TensorSpec((N, 3), f32)
        batch_sh["pos"] = rep
    n_graphs = None
    if dims["task"] == "node_class":
        batch["labels"] = TensorSpec((N,), i32)
        batch_sh["labels"] = rep
    else:
        n_graphs = dims["n_graphs"]
        batch["graph_id"] = TensorSpec((N,), i32)
        batch["targets"] = TensorSpec((n_graphs,), f32)
        batch_sh["graph_id"] = rep
        batch_sh["targets"] = rep

    def fwd_loss(params, b):
        g = GraphBatch(senders=b["senders"], receivers=b["receivers"],
                       node_feat=b["node_feat"],
                       edge_feat=b.get("edge_feat"), pos=b.get("pos"),
                       sender_plan=b["plans"][0], receiver_plan=b["plans"][1],
                       edge_chunk=b["edge_chunk"],
                       chunk_plans=b["chunk_plans"])
        out = fwd(cfg, params, g)
        out = out[0] if isinstance(out, tuple) else out
        if n_graphs is None:
            return node_class_loss(out, b["labels"], N)
        return graph_reg_loss(out, b["graph_id"], b["targets"], n_graphs,
                              b["graph_plan"])

    def reduce_grads(grads):
        # the data-parallel reduction of the weights applied to the
        # rank's edges, counted on every weight: an upper bound of its
        # traffic (the node-side weights' gradients are whole already)
        from torch.distributed import _functional_collectives as funcol

        return tree_map(lambda g: funcol.wait_tensor(funcol.all_reduce(
            g, "sum", dist.group.WORLD)), grads)

    step = gnn_train_step(fwd_loss, AdamWConfig(), donate=True,
                          grad_hook=reduce_grads)

    def rank_step(params, opt_state, b):
        with edge_parallel(dist.group.WORLD):
            return step(_local(params), _local(opt_state), _local(b))

    def make_inputs(args, fake_mode):
        params, opt_state, b = args
        b = dict(b, **_rank_index_arrays(
            b, fake_mode, n_graphs, getattr(cfg, "edge_chunk_size", None)))
        return params, opt_state, b

    opt = dict(mu=pshapes, nu=pshapes, step=TensorSpec((), i32))
    return DryrunCase(
        name=f"{arch_id}/{shape_name}", fn=rank_step,
        build_args=lambda: (pshapes, opt, batch),
        in_placements=(params_sh, dict(mu=params_sh, nu=params_sh, step=rep),
                       batch_sh),
        out_placements=(params_sh, dict(mu=params_sh, nu=params_sh,
                                        step=rep),
                        dict(loss=rep, grad_norm=rep, lr=rep)),
        model_flops=flops_fn(cfg, N, E),
        comment=dims.get("note", ""), make_inputs=make_inputs)


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


def register_gnn(arch_id, make_model, flops_fn, needs_pos=False,
                 needs_edge_feat=False, describe=""):
    return register(ArchSpec(
        arch_id=arch_id, family="gnn", shapes=GNN_SHAPES,
        make_dryrun_case=lambda shape, mesh: make_gnn_dryrun_case(
            arch_id, shape, mesh, make_model, flops_fn, needs_pos,
            needs_edge_feat),
        make_smoke_case=lambda device=None: make_gnn_smoke_case(
            make_model, needs_pos, needs_edge_feat, device=device),
        describe=describe))
