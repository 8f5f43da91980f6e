"""Multigrid setup: build the level hierarchy (paper §2; torch port of
``repro.core.hierarchy``).

The level schedule follows the paper: one low-degree elimination pass,
then aggregation; repeat until the coarsest graph is dense-solvable. Each
constructed level's capacity shrinks to a power-of-two bucket, and each
Alg 2 round's ⊕ goes through the fused ``agg_vote`` kernel on an ELL
layout of width ``setup_ell_width``.

Two execution modes (``SetupConfig.setup_mode``):

* ``"superstep"`` (default) — the per-level work runs as steps on arrays
  padded to power-of-two capacity buckets, with the level sizes on the
  device and one batched host fetch per constructed level
  (``repro_torch.core.setup_step``); :func:`build_hierarchy_batch` builds
  N graphs in lockstep, each bit-identical to its own build.
* ``"eager"`` — the host-driven loop, which reads sizes back inside every
  stage and builds each level at its exact shapes.

Both give the same hierarchy: the same levels, aggregates and elimination
masks, and bitwise the same PCG residuals.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import (AggregationConfig, aggregate,
                                          quantise_strength,
                                          renumber_aggregates,
                                          vote_edge_reduce)
from repro_torch.core.coarsen import contract
from repro_torch.core.cycles import CycleConfig, Transfer, cycle
from repro_torch.core.elimination import (EliminationLevel,
                                          build_elimination_level,
                                          select_eliminated)
from repro_torch.core.graph import (GraphLevel, graph_from_adjacency,
                                    laplacian_dense, pow2_bucket)
from repro_torch.core.setup_step import (build_hierarchy_superstep,
                                         build_hierarchy_superstep_batch)
from repro_torch.core.smoothers import estimate_lambda_max
from repro_torch.core.strength import STRENGTH_METRICS
from repro_torch.sparse.coo import COO
from repro_torch.sparse.ell import ell_layout_traced
from repro_torch.sparse.matvec import build_hybrid, validate_backend
from repro_torch.testing import faults

SETUP_MODES = ("superstep", "eager")


@dataclasses.dataclass(frozen=True)
class SetupConfig:
    max_levels: int = 20
    coarsest_size: int = 128
    elim_max_degree: int = 4          # paper: degree ≤ 4
    elim_min_fraction: float = 0.02   # skip ELIM levels that remove < 2%
    elim_rounds_per_level: int = 1    # paper: one pass suffices
    strength_metric: str = "algebraic_distance"   # paper's choice
    strength_vectors: int = 8
    strength_sweeps: int = 20
    aggregation: AggregationConfig = AggregationConfig()
    min_coarsen_ratio: float = 0.95   # stop if a level shrinks less than 5%
    seed: int = 0
    # solve-phase SpMV format (repro_torch.sparse.matvec): "coo", "ell"
    # (hybrid ELL+COO twin on every level, run by the kernels) or "auto"
    matvec_backend: str = "coo"
    ell_width_percentile: float = 95.0
    ell_width_cap: int = 64
    # "superstep" (bucket-padded steps, repro_torch.core.setup_step) or
    # "eager" (the host-driven loop); both give the same hierarchy
    setup_mode: str = "superstep"
    # power-of-two floor on the super-step buckets: levels smaller than it
    # share the floor-sized registry entries; 0 = exact power-of-two buckets
    setup_bucket_floor: int = 0
    # super-step elimination: "conservative" sizes the F-slot arrays at the
    # vertex bucket, so selection and the Schur build are one step with one
    # fetch; "exact" sizes them at bucket(n_elim), two fetches. The
    # hierarchies are bit-identical.
    elim_sizing: str = "conservative"
    # width of the ELL layout the Alg 2 vote kernel reduces over; longer
    # rows spill to the staged reduction, so any width is exact
    setup_ell_width: int = 8


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    transfers: tuple            # tuple[Transfer, ...]
    lam_maxes: tuple            # per-transfer λmax estimates (0.0 for ELIM)
    coarse_inv: torch.Tensor    # dense (L_c + α J)⁻¹ at the bottom

    @property
    def n_levels(self) -> int:
        return len(self.transfers) + 1


def _shrink(level: GraphLevel) -> GraphLevel:
    """Shrink capacity to the bucket of nnz (coalesce output keeps its
    padding last, so a slice is sound)."""
    adj = level.adj
    cap = pow2_bucket(max(adj.nnz, 1))
    if cap >= adj.capacity:
        return level
    return graph_from_adjacency(adj.with_capacity(cap))


def attach_ell_transfers(transfers: Sequence[Transfer],
                         cfg: SetupConfig) -> tuple:
    """Give every level of a built hierarchy its hybrid ELL+COO twin (under
    ``"auto"`` a level may keep its COO layout). ``t.coarse`` and
    ``t_next.fine`` stay one object."""
    validate_backend(cfg.matvec_backend)
    if cfg.matvec_backend == "coo":
        return tuple(transfers)
    cache: dict = {}

    def attach(level: GraphLevel) -> GraphLevel:
        out = cache.get(id(level))
        if out is None:
            plan = build_hybrid(level.adj, cfg.matvec_backend,
                                percentile=cfg.ell_width_percentile,
                                cap=cfg.ell_width_cap)
            out = level if plan is None else dataclasses.replace(
                level, ell=plan[0], ell_rem=plan[1])
            cache[id(level)] = out
        return out

    return tuple(dataclasses.replace(t, fine=attach(t.fine),
                                     coarse=attach(t.coarse))
                 for t in transfers)


def coarse_inverse(level: GraphLevel, alpha: float, row_h: np.ndarray,
                   col_h: np.ndarray) -> torch.Tensor:
    """Dense nullspace-regularised bottom solve ``(L_c + α Σ_c J_c)⁻¹``
    (one ``J = 11ᵀ/n`` on a connected coarse graph, one per component
    otherwise). ``torch.linalg.inv`` in float32: a plain dense product
    outside any kernel, as the reference leaves it to XLA."""
    from repro_torch.core.components import (component_ones_matrix,
                                             connected_components)

    L = laplacian_dense(level)
    n_c = level.n
    m = (row_h < n_c) & (col_h < n_c)
    comp, n_comp = connected_components(n_c, row_h[m], col_h[m])
    if n_comp == 1:
        ones = torch.ones((n_c, n_c), dtype=L.dtype, device=L.device)
        inv = torch.linalg.inv(L + alpha * ones / n_c)
    else:
        reg = torch.as_tensor(component_ones_matrix(comp, n_comp),
                              device=L.device)
        inv = torch.linalg.inv(L + alpha * reg)
    return faults.site("setup.coarse_inv", inv)


def _check_mode(cfg: SetupConfig) -> None:
    if cfg.setup_mode not in SETUP_MODES:
        raise ValueError(f"setup_mode must be one of {SETUP_MODES}, "
                         f"got {cfg.setup_mode!r}")


def build_hierarchy(adj: COO, cfg: SetupConfig = SetupConfig()) -> Hierarchy:
    """Build the multigrid hierarchy in the configured ``setup_mode``."""
    faults.checkpoint("setup.build")
    _check_mode(cfg)
    if cfg.setup_mode == "superstep":
        return build_hierarchy_superstep(adj, cfg)
    return build_hierarchy_eager(adj, cfg)


def build_hierarchy_batch(adjs: Sequence[COO],
                          cfg: SetupConfig = SetupConfig()) -> list:
    """Build N hierarchies (graphs on one device) as one batched run.

    The setup plans of all graphs advance in lockstep rounds: steps whose
    levels land in the same capacity buckets share one registry entry, and
    all pending level decisions share one host fetch a round
    (``repro_torch.core.setup_step.build_hierarchy_superstep_batch``).
    Every hierarchy is bit-identical to a looped :func:`build_hierarchy`
    of the same graph; a ``setup_bucket_floor`` covering the batch keeps
    same-family graphs in one group end to end. ``setup_mode="eager"``
    loops over :func:`build_hierarchy_eager`.
    """
    faults.checkpoint("setup.build")
    _check_mode(cfg)
    if cfg.setup_mode == "superstep":
        return build_hierarchy_superstep_batch(adjs, cfg)
    return [build_hierarchy_eager(adj, cfg) for adj in adjs]


def build_hierarchy_eager(adj: COO,
                          cfg: SetupConfig = SetupConfig()) -> Hierarchy:
    """The host-driven setup loop (``setup_mode="eager"``)."""
    level = graph_from_adjacency(adj)
    transfers: List[Transfer] = []
    lam_maxes: list = []
    strength_fn = STRENGTH_METRICS[cfg.strength_metric]
    acfg = cfg.aggregation

    while level.n > cfg.coarsest_size and len(transfers) < cfg.max_levels:
        progressed = False

        # --- low-degree elimination pass(es) ---------------------------
        for _ in range(cfg.elim_rounds_per_level):
            if level.n <= cfg.coarsest_size:
                break
            elim = select_eliminated(level, cfg.elim_max_degree)
            n_elim = int(elim.sum())
            if n_elim < max(cfg.elim_min_fraction * level.n, 1) \
                    or n_elim == level.n:
                break
            t = build_elimination_level(level, elim, n_f=n_elim,
                                        max_degree=cfg.elim_max_degree)
            t = dataclasses.replace(t, coarse=_shrink(t.coarse))
            transfers.append(t)
            lam_maxes.append(torch.zeros((), device=adj.device))
            level = t.coarse
            progressed = True

        if level.n <= cfg.coarsest_size:
            break

        # --- aggregation level -----------------------------------------
        strength = strength_fn(level, n_vectors=cfg.strength_vectors,
                               n_sweeps=cfg.strength_sweeps, seed=cfg.seed)
        # quantised strengths in the vote kernel's ELL layout, built once
        # and reused by every round (only the state vector changes)
        lay = ell_layout_traced(level.adj.row, level.adj.col, level.n,
                                cfg.setup_ell_width)
        sq = quantise_strength(strength, acfg)
        sq_table, sq_spill = lay.table(sq), lay.spill(sq)

        def edge_reduce(state, lay=lay, sq_table=sq_table,
                        sq_spill=sq_spill):
            return vote_edge_reduce(lay, sq_table, sq_spill, state, acfg)

        aggs, _state = aggregate(level, None, acfg, edge_reduce=edge_reduce)
        coarse_id, n_c = renumber_aggregates(aggs, level.n)
        if n_c >= level.n * cfg.min_coarsen_ratio:
            if not progressed:
                break  # stuck: neither mechanism coarsens this graph
            continue
        t = contract(level, coarse_id, n_c)
        t = dataclasses.replace(t, coarse=_shrink(t.coarse))
        lam_maxes.append(faults.site("setup.lambda_max",
                                     estimate_lambda_max(level)))
        transfers.append(t)
        level = t.coarse

    # --- dense bottom solve: (L_c + α Σ_c J_c)⁻¹ -------------------------
    alpha = float(level.deg.mean())
    coarse_inv = coarse_inverse(level, alpha or 1.0,
                                level.adj.row.cpu().numpy(),
                                level.adj.col.cpu().numpy())
    return Hierarchy(transfers=attach_ell_transfers(transfers, cfg),
                     lam_maxes=tuple(lam_maxes), coarse_inv=coarse_inv)


def apply_cycle(h: Hierarchy, b: torch.Tensor,
                cfg: CycleConfig = CycleConfig()) -> torch.Tensor:
    """One multigrid cycle as preconditioner application: z ≈ L⁻¹ b."""
    return cycle(h.transfers, h.lam_maxes, h.coarse_inv, b, cfg)


def hierarchy_stats(h: Hierarchy) -> dict:
    """Per-level stats rows: kind, n, nnz, capacity, ELL width and spill."""
    levels = [t.fine for t in h.transfers]
    kinds = ["elim" if isinstance(t, EliminationLevel) else "agg"
             for t in h.transfers]
    if h.transfers:
        levels.append(h.transfers[-1].coarse)
        kinds.append("coarse")
    rows = []
    for kind, level in zip(kinds, levels):
        ell = level.ell
        rem = level.ell_rem
        rows.append(dict(kind=kind, n=level.n, nnz=level.adj.nnz,
                         capacity=level.adj.capacity,
                         ell_width=None if ell is None else ell.width,
                         ell_spill=None if ell is None else
                         (0 if rem is None else rem.nnz)))
    return dict(levels=rows, n_levels=h.n_levels)
