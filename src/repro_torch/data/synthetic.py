"""Seeded synthetic data: the port's own copy of ``repro.data.synthetic``
(``lm_batch_stream``, ``recsys_batch_stream``, ``gnn_graph_batch``,
``neighbor_sampled_batch``).

numpy only, so every stream is bit-identical to the reference's for the
same arguments: deterministic per (seed, step, host), so a restarted job
replays the exact stream from its checkpoint step. Generation is host
numpy, sharded by ``host_id/num_hosts`` slicing like a loader over a file
shard list.
"""

from __future__ import annotations

import numpy as np


def lm_batch_stream(vocab: int, batch: int, seq_len: int, seed: int = 0,
                    start_step: int = 0, host_id: int = 0, num_hosts: int = 1):
    """Yields (step, tokens [batch, seq_len+1] int32) — +1 for the shifted
    next-token target. Zipf-ish marginal over the vocab (LM-like)."""
    b_local = batch // num_hosts
    step = start_step
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, host_id]))
        u = rng.random((b_local, seq_len + 1))
        toks = np.minimum((u ** -1.2).astype(np.int64), vocab) - 1
        yield step, np.clip(toks, 0, vocab - 1).astype(np.int32)
        step += 1


def recsys_batch_stream(vocab_per_field, batch: int, multi_hot: int = 1,
                        seed: int = 0, start_step: int = 0,
                        host_id: int = 0, num_hosts: int = 1):
    """Yields (step, indices [B, F, H] int32 field-local, labels [B])."""
    F = len(vocab_per_field)
    sizes = np.asarray(vocab_per_field)
    b_local = batch // num_hosts
    step = start_step
    while True:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed + 1, step, host_id]))
        u = rng.random((b_local, F, multi_hot))
        idx = np.minimum((u ** -1.1), sizes[None, :, None]).astype(np.int64) - 1
        idx = np.clip(idx, 0, sizes[None, :, None] - 1).astype(np.int32)
        # CTR-like labels correlated with a few feature hashes
        sig = (idx[:, 0, 0] % 7 == 0) | (idx[:, 1, 0] % 11 == 0)
        noise = rng.random(b_local) < 0.15
        labels = (sig ^ noise).astype(np.float32)
        yield step, idx, labels
        step += 1


def gnn_graph_batch(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                    d_edge: int = 0, with_pos: bool = False,
                    n_classes: int = 8):
    """One padded random graph batch (full-graph shapes)."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    receivers = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    out = dict(senders=senders, receivers=receivers, node_feat=feats,
               labels=rng.integers(0, n_classes, n_nodes).astype(np.int32))
    if d_edge:
        out["edge_feat"] = rng.normal(size=(n_edges, d_edge)).astype(np.float32)
    if with_pos:
        out["pos"] = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    return out


def neighbor_sampled_batch(csr_indptr, csr_indices, batch_nodes: int,
                           fanouts=(15, 10), seed: int = 0, d_feat: int = 100,
                           features: np.ndarray | None = None):
    """GraphSAGE-style k-hop neighbour sampling (the real sampler the
    ``minibatch_lg`` shape requires).

    Returns padded (senders, receivers, node ids, features) where layer-k
    edges point sampled neighbours -> their seed. Node count is padded to
    the worst case ``batch·(1 + f1 + f1·f2)`` so shapes are static.
    """
    rng = np.random.default_rng(seed)
    n = len(csr_indptr) - 1
    seeds = rng.choice(n, size=batch_nodes, replace=False)

    all_nodes = [seeds]
    send_list, recv_list = [], []
    frontier = seeds
    offset = 0
    for f in fanouts:
        next_frontier = []
        base = offset
        next_off = offset + len(frontier)
        for local_i, v in enumerate(frontier):
            lo, hi = csr_indptr[v], csr_indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = rng.integers(0, deg, size=f)
            nbrs = csr_indices[lo + take]
            start = next_off + len(next_frontier)
            next_frontier.extend(nbrs.tolist())
            src = np.arange(start, start + len(nbrs))
            dst = np.full(len(nbrs), base + local_i)
            send_list.append(src)
            recv_list.append(dst)
        frontier = np.asarray(next_frontier, dtype=np.int64)
        all_nodes.append(frontier)
        offset = next_off

    nodes = np.concatenate(all_nodes)
    senders = (np.concatenate(send_list) if send_list
               else np.zeros(0, np.int64))
    receivers = (np.concatenate(recv_list) if recv_list
                 else np.zeros(0, np.int64))

    # pad to static worst case
    max_nodes = batch_nodes * (1 + fanouts[0] * (1 + (fanouts[1] if len(fanouts) > 1 else 0)))
    max_edges = batch_nodes * fanouts[0] * (1 + (fanouts[1] if len(fanouts) > 1 else 0))
    pn = np.zeros(max_nodes, np.int64)
    pn[: len(nodes)] = nodes
    ps = np.full(max_edges, max_nodes, np.int32)
    pr = np.full(max_edges, max_nodes, np.int32)
    ps[: len(senders)] = senders
    pr[: len(receivers)] = receivers
    if features is not None:
        feats = features[pn].astype(np.float32)
        feats[len(nodes):] = 0
    else:
        feats = np.random.default_rng(seed + 1).normal(
            size=(max_nodes, d_feat)).astype(np.float32)
    return dict(senders=ps, receivers=pr, node_ids=pn, node_feat=feats,
                n_real_nodes=len(nodes), n_real_edges=len(senders),
                seeds=seeds)
