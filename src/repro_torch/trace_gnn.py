"""Where the time of a GNN training step goes on the card.

    python -m repro_torch.trace_gnn
        [--arch meshgraphnet|pna|egnn|equiformer-v2] [--trace-dir DIR]

Builds ``minibatch_lg`` (``configs.gnn_common.minibatch_lg_graph``: the
neighbour-sampled subgraph of a seeded Barabási–Albert stand-in, 169,984
node and 168,960 edge slots, 602 features) with its plans (the
endpoints' two, and for Equiformer-v2 each edge chunk's two), and the
model at its config's ``FULL`` widths (weights from a seeded generator),
and profiles, with ``trace_solve.profile_call``, one warm training step
(``gnn_train_step`` on ``node_class_loss``, AdamW with f32 moments), then
its parts alone: the forward (``forward``, no graph), the loss and
gradients (``grads``) and AdamW (``adamw``). For each: the untraced wall
time, device time by kernel name, the number of launches and the
device's busy share, and the device time and launches summed by group:
the matrix products (``gemm``), the gather and scatter kernels
(``bag_forward``: ``csrc/embedding_bag.cu``; ``bag_backward``:
``csrc/embedding_bag_backward.cu``), the reductions (``reduce``: the
LayerNorm's means and variances, the losses, AdamW's norm), the
elementwise passes (``elementwise``: SiLU, the LayerNorm's arithmetic,
the residual adds, AdamW) and the rest (``other``: concatenations,
copies, PNA's max/min scatter, Equiformer-v2's edge-softmax maximum;
its rotations are batched products, so they count under ``gemm``), and
each part's peak memory (GiB). ``--trace-dir`` writes one Chrome trace
per part. Prints one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

# device kernels by group, by a part of the name the profiler reports
# (first match wins; everything else is "other")
GNN_GROUPS = (("bag_forward", ("bag_tiles_kernel", "bag_rows_gather")),
              ("bag_backward", ("bag_grad_chunks", "bag_grad_finish",
                                "bag_rows_sums", "bag_rows_finish")),
              ("gemm", ("gemm", "gemv", "xmma")),
              ("reduce", ("reduce_kernel",)),
              ("elementwise", ("elementwise_kernel",)))


def gnn_groups(kernels) -> dict:
    """``{group: total}`` of ``(kernel name, ms or launches)`` pairs."""
    out = {}
    for name, x in kernels:
        group = next((g for g, parts in GNN_GROUPS
                      if any(p in name for p in parts)), "other")
        out[group] = round(out.get(group, 0) + x, 4)
    return out


def main(argv=None) -> int:
    import torch

    from repro_torch.configs.gnn_common import (gnn_train_step,
                                                minibatch_lg_graph,
                                                node_class_loss)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.trace_solve import profile_call
    from repro_torch.tree import value_and_grad

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="meshgraphnet",
                    choices=("meshgraphnet", "pna", "egnn", "equiformer-v2"))
    ap.add_argument("--trace-dir", default=None,
                    help="directory for one Chrome trace per part")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_gnn: needs a CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    dev = torch.device("cuda")
    g, labels = minibatch_lg_graph(dev)
    mod = importlib.import_module(
        f"repro_torch.configs.{args.arch.replace('-', '_')}")
    cfg, init, fwd = mod.make_model("minibatch_lg", g.node_feat.shape[1])
    g = g.with_plans(edge_chunk=getattr(cfg, "edge_chunk_size", None))
    params = init(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    opt = adamw_init(params, opt_cfg)
    batch = dict(graph=g, labels=labels)

    def loss_fn(p, b):
        out = fwd(cfg, p, b["graph"])
        out = out[0] if isinstance(out, tuple) else out
        return node_class_loss(out, b["labels"], b["graph"].n_nodes)

    def loss(p):
        return loss_fn(p, batch)

    step = gnn_train_step(loss_fn, opt_cfg)
    _, grads = value_and_grad(loss, params)

    def forward():
        with torch.no_grad():
            return loss(params)

    # the same state every call; then the step's parts alone
    parts = dict(step=lambda: step(params, opt, batch), forward=forward,
                 grads=lambda: value_and_grad(loss, params),
                 adamw=lambda: adamw_update(opt_cfg, params, grads, opt))
    out = dict(device=torch.cuda.get_device_name(0), arch=args.arch,
               layers=cfg.n_layers, nodes=g.n_nodes, edges=g.n_edges,
               model_flop_per_step=mod.flops(cfg, g.n_nodes, g.n_edges))
    for part, fn in parts.items():
        path = (f"{args.trace_dir}/gnn_{args.arch}_{part}.json"
                if args.trace_dir else None)
        torch.cuda.reset_peak_memory_stats()
        res = profile_call(torch, fn, path, top=1000)[1]
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["groups_ms"] = gnn_groups((k["name"], k["ms"])
                                      for k in res["top_kernels"])
        res["groups_launches"] = gnn_groups((k["name"], k["count"])
                                            for k in res["top_kernels"])
        res["top_kernels"] = res["top_kernels"][:12]
        out[part] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
