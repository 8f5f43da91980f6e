"""Parallel aggregation by voting (paper §2.4, Algorithm 2; torch port of
``repro.core.aggregation``).

Each round is one semiring SpMV over the adjacency:
  ⊗ : edge (i→j) emits (state_j, strength_ij, j), dropping Decided neighbours
  ⊕ : lexicographic max on (state, strength), tie-break min id
followed by the replicated state update. As in the reference, lines 20–27
of Alg 2 apply only to Undecided vertices. After the rounds, still
Undecided vertices become singletons and aggregate ids are renumbered
contiguously.

The setup runs each round's ⊕ through the fused ``agg_vote`` kernel on an
ELL layout of the adjacency, with the rows that overflow the layout's
width reduced by the staged segment reduction and merged exactly
(:func:`vote_edge_reduce`): the ⊕ is an integer reduction, so this is bit
for bit the staged ``segment_argmax_lex`` over the raw edge list.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import GraphLevel
from repro_torch.sparse.segment import (group_ids, segment_argmax_lex,
                                        segment_sum, segment_sum_groups,
                                        take_fill, take_groups)

DECIDED = 0
UNDECIDED = 1
SEED = 2

_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class AggregationConfig:
    n_rounds: int = 10
    seed_votes: int = 8
    # strengths in (0,1] are packed into the lexicographic key as int32
    # levels, which keeps ⊕ a pure integer reduction
    strength_levels: int = 1 << 20


def _pack_state_strength(state, strength_q, levels: int) -> torch.Tensor:
    """(state, strength) -> one int32 key; state dominates."""
    return (state.to(torch.int32) * (levels + 2)
            + strength_q.to(torch.int32))


def quantise_strength(strength: torch.Tensor,
                      cfg: AggregationConfig) -> torch.Tensor:
    """Per-edge strengths in (0, 1] -> int32 levels for the vote key."""
    return torch.clamp((strength * cfg.strength_levels).to(torch.int32), 0,
                       cfg.strength_levels)


def lex_combine(k1, i1, k2, i2):
    """⊕-merge two partial vote reductions: max key, then min id among the
    attaining sides (exact: the integer ⊕ is associative/commutative)."""
    k = torch.maximum(k1, k2)
    i = torch.minimum(torch.where(k1 == k, i1, _I32_MAX),
                      torch.where(k2 == k, i2, _I32_MAX))
    return k, i


def vote_edge_reduce(layout, sq_table: torch.Tensor, spill_sq: torch.Tensor,
                     state: torch.Tensor, cfg: AggregationConfig):
    """One round's edge ⊕: the ELL tile through the vote kernel, the
    spilled entries through the staged segment reduction, lex-merged."""
    from repro_torch.kernels.agg_vote import vote_reduce

    n = layout.n_rows
    best_k, best_i = vote_reduce(layout.col_table, sq_table, state,
                                 levels=cfg.strength_levels, decided=DECIDED)
    nbr_state = take_fill(state, layout.spill_col, DECIDED)
    emit_ok = (layout.spill_row < n) & (nbr_state != DECIDED)
    key = _pack_state_strength(nbr_state, spill_sq, cfg.strength_levels)
    sp_k, _, sp_i = segment_argmax_lex(key, torch.zeros_like(key),
                                       layout.spill_col, layout.spill_row,
                                       n, valid=emit_ok)
    return lex_combine(best_k, best_i, sp_k, sp_i)


def vote_edge_reduce_groups(layout, sq_table: torch.Tensor,
                            spill_sq: torch.Tensor, state: torch.Tensor,
                            cfg: AggregationConfig):
    """:func:`vote_edge_reduce` of every graph of a group (``state`` ``[G,
    n]``, ``layout`` a ``sparse.ell.GroupEllLayout``): the group's ELL
    tables through ONE launch of the graph-batched vote kernel, the
    spilled entries through one staged reduction over the stacked ids,
    lex-merged. Returns ``[G, n]`` keys and each graph's own ids."""
    from repro_torch.kernels.agg_vote import vote_reduce_batched

    g, n = state.shape
    w = layout.width
    best_k, best_i = vote_reduce_batched(
        layout.col_table.view(g, n, w), sq_table.view(g, n, w), state,
        levels=cfg.strength_levels, decided=DECIDED)
    nbr_state = take_groups(state, layout.spill_col, DECIDED)
    emit_ok = (layout.spill_row < n) & (nbr_state != DECIDED)
    key = _pack_state_strength(nbr_state, spill_sq,
                               cfg.strength_levels).reshape(-1)
    sp_k, _, sp_i = segment_argmax_lex(
        key, torch.zeros_like(key), layout.spill_col.reshape(-1),
        group_ids(layout.spill_row, n).reshape(-1), g * n,
        valid=emit_ok.reshape(-1))
    return lex_combine(best_k, best_i, sp_k.view(g, n), sp_i.view(g, n))


def apply_vote_update(state, votes, aggregates, best_key, best_id,
                      cfg: AggregationConfig):
    """The replicated state update of one Alg 2 round, given the per-vertex
    ⊕ results ``(best_key, best_id)``: ``[n]`` vectors, or ``[G, n]``
    (each graph of a group its own update)."""
    n = state.shape[-1]
    iota = torch.arange(n, dtype=torch.int32, device=state.device)
    best_state = torch.where(
        best_key >= 0, torch.div(best_key, cfg.strength_levels + 2,
                                 rounding_mode="floor"), DECIDED)
    has_best = best_id < _I32_MAX

    undecided = state == UNDECIDED
    join = undecided & has_best & (best_state == SEED)
    vote = undecided & has_best & (best_state == UNDECIDED)

    # joining vertices adopt the seed's aggregate id (= the seed's own id)
    aggregates = torch.where(join, best_id, aggregates)
    state = torch.where(join, DECIDED, state)

    tgt = torch.where(vote, best_id, n)
    count = segment_sum if tgt.dim() == 1 else segment_sum_groups
    votes = votes + count(torch.ones_like(tgt), tgt, n)

    promote = (state == UNDECIDED) & (votes > cfg.seed_votes)
    state = torch.where(promote, SEED, state)
    aggregates = torch.where(promote, iota, aggregates)
    return state, votes, aggregates


def aggregation_round(level: GraphLevel, strength_q, state, votes,
                      aggregates, cfg: AggregationConfig):
    """One voting round with the staged reduction over the edge list."""
    adj = level.adj
    nbr_state = take_fill(state, adj.col, DECIDED)
    emit_ok = adj.valid & (nbr_state != DECIDED)
    key = _pack_state_strength(nbr_state, strength_q, cfg.strength_levels)
    best_key, _, best_id = segment_argmax_lex(
        key, torch.zeros_like(key), adj.col, adj.row, level.n, valid=emit_ok)
    return apply_vote_update(state, votes, aggregates, best_key, best_id, cfg)


def aggregate(level: GraphLevel, strength,
              cfg: AggregationConfig = AggregationConfig(),
              n_valid=None, edge_reduce=None):
    """Run Alg 2. Returns (aggregates [n] int32 root-vertex ids, state).

    ``n_valid``: the count of real vertices (an int or a 0-d tensor) when
    ``level`` is bucket-padded. Padding vertices start Decided, so they
    never vote, join or seed: the first ``n_valid`` outputs are those of
    the unpadded run. ``edge_reduce``: optional ``state -> (best_key,
    best_id)`` override of the per-round ⊕; with it ``strength`` may be
    None.
    """
    n = level.n
    dev = level.deg.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    state = torch.full((n,), UNDECIDED, dtype=torch.int32, device=dev)
    if n_valid is not None:
        state = torch.where(iota < n_valid, state, DECIDED)
    votes = torch.zeros(n, dtype=torch.int32, device=dev)
    aggregates = iota.clone()
    if edge_reduce is None:
        strength_q = quantise_strength(strength, cfg)
    for _ in range(cfg.n_rounds):
        if edge_reduce is None:
            state, votes, aggregates = aggregation_round(
                level, strength_q, state, votes, aggregates, cfg)
        else:
            best_key, best_id = edge_reduce(state)
            state, votes, aggregates = apply_vote_update(
                state, votes, aggregates, best_key, best_id, cfg)
    # leftover Undecided vertices and seeds anchor their own aggregate
    aggregates = torch.where((state == UNDECIDED) | (state == SEED), iota,
                             aggregates)
    return aggregates, state


def renumber_device(aggregates: torch.Tensor, n_valid=None):
    """Contiguous renumbering in increasing root-vertex order. Returns
    ``(coarse_id int32 [n], n_coarse, ok)`` as tensors, where ``ok`` says
    every non-root pointer hits a root. ``n_valid`` masks bucket padding:
    padding vertices point at themselves but are neither roots nor
    checked."""
    n = aggregates.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=aggregates.device)
    roots = aggregates == iota
    if n_valid is not None:
        roots = roots & (iota < n_valid)
    root_rank = (torch.cumsum(roots.to(torch.int32), 0) - 1).to(torch.int32)
    coarse_id = take_fill(root_rank, aggregates, 0)
    hits_root = take_fill(roots, aggregates, False)
    if n_valid is not None:
        hits_root = hits_root | (iota >= n_valid)
    return coarse_id, roots.sum(), hits_root.all()


def aggregate_groups(n_valid: torch.Tensor, n: int, edge_reduce,
                     cfg: AggregationConfig = AggregationConfig()):
    """:func:`aggregate` of every graph of a group of bucket-padded levels
    of ``n`` vertices, ``n_valid`` ``[G]`` their real counts and
    ``edge_reduce`` the group's per-round ⊕ (``[G, n] -> ([G, n], [G,
    n])``). Returns ``[G, n]`` aggregates and states, graph g's its own
    run's."""
    dev = n_valid.device
    g = n_valid.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    state = torch.full((g, n), UNDECIDED, dtype=torch.int32, device=dev)
    state = torch.where(iota < n_valid[:, None], state, DECIDED)
    votes = torch.zeros((g, n), dtype=torch.int32, device=dev)
    aggregates = iota.expand(g, n).clone()
    for _ in range(cfg.n_rounds):
        best_key, best_id = edge_reduce(state)
        state, votes, aggregates = apply_vote_update(
            state, votes, aggregates, best_key, best_id, cfg)
    aggregates = torch.where((state == UNDECIDED) | (state == SEED), iota,
                             aggregates)
    return aggregates, state


def renumber_device_groups(aggregates: torch.Tensor, n_valid: torch.Tensor):
    """:func:`renumber_device` of every graph of a group: ``aggregates``
    ``[G, n]``, ``n_valid`` ``[G]``; returns ``[G, n]`` coarse ids and the
    ``[G]`` coarse counts and invariants."""
    n = aggregates.shape[1]
    iota = torch.arange(n, dtype=torch.int32, device=aggregates.device)
    real = iota < n_valid[:, None]
    roots = (aggregates == iota) & real
    root_rank = (torch.cumsum(roots.to(torch.int32), 1) - 1).to(torch.int32)
    coarse_id = take_groups(root_rank, aggregates, 0)
    hits_root = take_groups(roots, aggregates, False) | ~real
    return coarse_id, roots.sum(1), hits_root.all(1)


def renumber_aggregates(aggregates: torch.Tensor, n: int):
    """Contiguous coarse ids (the paper's global reordering). Returns
    ``(coarse_id [n] int32, n_coarse int)``."""
    if aggregates.shape[0] != n:
        raise ValueError(f"aggregates length {aggregates.shape[0]} != n {n}")
    coarse_id, n_coarse, ok = renumber_device(aggregates)
    if not bool(ok):
        raise RuntimeError("aggregate pointers must hit roots")
    return coarse_id, int(n_coarse)
