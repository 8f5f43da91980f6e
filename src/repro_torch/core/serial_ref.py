"""Serial LAMG-style reference solver (the paper's Fig 3 comparison column;
torch port of ``repro.core.serial_ref``).

A serial-flavoured LAMG-lite with the two serial mechanisms the paper
gives up for parallelism, on the same level constructors as the parallel
solver:

* **greedy sequential elimination** — sweep vertices in degree order,
  eliminate any degree ≤ 4 vertex with no previously eliminated
  neighbour;
* **greedy strength-ordered aggregation** — process edges by descending
  affinity, pairing and absorbing vertices up to a maximum aggregate size.

The greedy passes are serial host loops (numpy/scipy) by design: each
copies its level's arrays to the host once. Elimination, strength,
contraction, λmax, the coarse inverse, the ELL twins and the solve run on
the level's device, so Fig 3's comparison isolates the quality lost to
the parallel setup decisions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.core.aggregation import renumber_aggregates
from repro_torch.core.coarsen import contract
from repro_torch.core.cycles import CycleConfig
from repro_torch.core.elimination import build_elimination_level
from repro_torch.core.graph import GraphLevel, graph_from_adjacency
from repro_torch.core.hierarchy import (Hierarchy, SetupConfig, _shrink,
                                        attach_ell_transfers, coarse_inverse)
from repro_torch.core.smoothers import estimate_lambda_max
from repro_torch.core.solver import LaplacianSolver, _prepare
from repro_torch.core.strength import STRENGTH_METRICS
from repro_torch.device import resolve_device
from repro_torch.sparse.coo import COO


def _host_edges(level: GraphLevel, *extra: torch.Tensor) -> list:
    """The level's real entries on the host, one copy a tensor: ``row``,
    ``col`` and each per-entry array of ``extra`` (``level.adj.val``, a
    strength), all masked to ``row < n``."""
    row = level.adj.row.cpu().numpy()
    ok = row < level.n
    return [row[ok], level.adj.col.cpu().numpy()[ok],
            *(t.cpu().numpy()[ok] for t in extra)]


def _to_csr(level: GraphLevel) -> sp.csr_matrix:
    row, col, val = _host_edges(level, level.adj.val)
    return sp.csr_matrix((val, (row, col)), shape=(level.n, level.n))


def greedy_eliminate_mask(level: GraphLevel, max_degree: int = 4) -> np.ndarray:
    a = _to_csr(level)
    deg = np.diff(a.indptr)
    order = np.argsort(deg, kind="stable")
    state = np.zeros(level.n, np.int8)  # 0 untouched, 1 eliminated, 2 blocked
    for v in order:
        if deg[v] > max_degree or state[v] != 0:
            continue
        nbrs = a.indices[a.indptr[v]:a.indptr[v + 1]]
        if (state[nbrs] == 1).any():
            continue
        state[v] = 1
        state[nbrs[state[nbrs] == 0]] = 2
    return state == 1


def greedy_aggregate(level: GraphLevel, strength: torch.Tensor,
                     max_size: int = 8) -> np.ndarray:
    """Root-vertex aggregate ids from the edges in descending ``strength``
    order (a tensor aligned with ``level.adj``)."""
    row, col, s = _host_edges(level, strength)
    order = np.argsort(-s, kind="stable")
    agg = np.arange(level.n)
    size = np.ones(level.n, np.int64)
    assigned = np.zeros(level.n, bool)
    for e in order:
        u, v = int(row[e]), int(col[e])
        if not assigned[u] and not assigned[v]:
            agg[v] = u
            assigned[u] = assigned[v] = True
            size[u] = 2
        elif assigned[u] and not assigned[v]:
            root = int(agg[u])
            if size[root] < max_size:
                agg[v] = root
                assigned[v] = True
                size[root] += 1
        elif assigned[v] and not assigned[u]:
            root = int(agg[v])
            if size[root] < max_size:
                agg[u] = root
                assigned[u] = True
                size[root] += 1
    # Roots point at themselves; leftovers are singleton roots.
    for v in range(level.n):
        if agg[v] != v and agg[agg[v]] != agg[v]:
            agg[v] = agg[agg[v]]  # path-compress one step (depth ≤ 2 here)
    return agg


def build_serial_hierarchy(adj: COO, cfg: SetupConfig = SetupConfig()
                           ) -> Hierarchy:
    """The greedy setup loop on ``adj``'s device."""
    level = graph_from_adjacency(adj)
    dev = adj.device
    transfers, lam_maxes = [], []
    strength_fn = STRENGTH_METRICS["affinity"]  # LAMG's metric

    while level.n > cfg.coarsest_size and len(transfers) < cfg.max_levels:
        progressed = False
        elim = greedy_eliminate_mask(level, cfg.elim_max_degree)
        if elim.sum() >= max(cfg.elim_min_fraction * level.n, 1):
            t = build_elimination_level(level, torch.as_tensor(elim,
                                                               device=dev),
                                        max_degree=cfg.elim_max_degree)
            t = dataclasses.replace(t, coarse=_shrink(t.coarse))
            transfers.append(t)
            lam_maxes.append(torch.zeros((), device=dev))
            level = t.coarse
            progressed = True
        if level.n <= cfg.coarsest_size:
            break
        strength = strength_fn(level, n_vectors=cfg.strength_vectors,
                               n_sweeps=cfg.strength_sweeps, seed=cfg.seed)
        aggs = greedy_aggregate(level, strength)
        coarse_id, n_c = renumber_aggregates(
            torch.as_tensor(aggs.astype(np.int32), device=dev), level.n)
        if n_c >= level.n * cfg.min_coarsen_ratio:
            if not progressed:
                break
            continue
        t = contract(level, coarse_id, n_c)
        t = dataclasses.replace(t, coarse=_shrink(t.coarse))
        lam_maxes.append(estimate_lambda_max(t.fine))
        transfers.append(t)
        level = t.coarse

    alpha = float(level.deg.mean())
    coarse_inv = coarse_inverse(level, alpha or 1.0,
                                level.adj.row.cpu().numpy(),
                                level.adj.col.cpu().numpy())
    return Hierarchy(transfers=attach_ell_transfers(transfers, cfg),
                     lam_maxes=tuple(lam_maxes), coarse_inv=coarse_inv)


def serial_lamg_solver(n, rows, cols, vals,
                       setup_config: SetupConfig = SetupConfig(),
                       cycle_config: CycleConfig = CycleConfig(),
                       capacity=None, random_ordering: bool = False,
                       device=None) -> LaplacianSolver:
    """The serial reference solver on ``device`` (default: the CUDA card).

    ``random_ordering`` applies the parallel solvers' §2.2 relabeling (a
    pure relabeling, permuted back transparently); here it only
    reshuffles the greedy sweeps' tie-breaking."""
    dev = resolve_device(device)
    prep, adj = _prepare(n, rows, cols, vals, setup_config.seed,
                         random_ordering, capacity, dev)
    return LaplacianSolver(hierarchy=build_serial_hierarchy(adj, setup_config),
                           cycle_config=cycle_config, device=dev, **prep)
