"""Distributed SETUP phase: the paper's Alg 1 / Alg 2 over the 2D partition
(torch port of ``repro.dist.setup``).

Both setup algorithms are semiring SpMVs, so their distributed form has
the shape of the distributed solve SpMV:

* each rank segment-reduces its block-local edges (the ⊗ products) by
  *global* row id,
* the cross-block ⊕ is one ``all_reduce`` (MIN/MAX) over the mesh: the
  paper's column-communicator reduce followed by the row broadcast,
  collapsed into one collective (exact for idempotent ⊕),
* the elementwise state updates are replicated, like the paper's
  vector-duplicated MPI ranks after the all-reduce.

The lexicographic ⊕ operators are staged as in
``repro_torch.sparse.segment.segment_argmin_lex``/``segment_argmax_lex``:
reduce the primary key, mask the entries that do not attain it, then
reduce the id. Every sharded reduction is an integer ⊕, so each result
bit-matches its single-device twin on any mesh.

Two layers:

**Partition-level primitives** (:func:`distributed_select_eliminated`,
:func:`distributed_vote_round`, :func:`distributed_aggregate`) on an
explicit host-built :class:`~repro_torch.dist.partition.Partition2D`:
every rank takes its own block.

**The distributed super-step setup** (:func:`build_hierarchy_superstep_dist`
/ :class:`DistSuperstepBuilders`) plugs the same reductions into the
bucketed setup loop of ``repro_torch.core.setup_step`` through its
``select_fn``/``vote_factory`` hooks. Between levels the partition is
re-derived on the device: the carry after each coalesce is sorted by
``(row, col)`` with padding last, so rank ``r``'s edge block is the
``r``-th of equal contiguous slices, and its ELL row block the ``r``-th of
equal row ranges of the vote layout. Alg 2's vote runs the ``agg_vote``
kernel on the rank's row block. The float stages (weighted degrees,
strengths, Schur fill, λmax) stay replicated, so the distributed hierarchy
is bit for bit the serial super-step's on any mesh, and the setup keeps
the serial contract of one batched host fetch per constructed level.
"""

from __future__ import annotations

import torch

from repro_torch.core.aggregation import (DECIDED, SEED, UNDECIDED,
                                          AggregationConfig,
                                          _pack_state_strength,
                                          apply_vote_update)
from repro_torch.core.graph import hash32
from repro_torch.core.setup_step import (SuperstepBuilders,
                                         build_hierarchy_superstep)
from repro_torch.dist.mesh import ProcessMesh
from repro_torch.dist.partition import Partition2D, rank_block
from repro_torch.sparse.segment import (segment_max, segment_min,
                                        segment_sum, take_fill)
from repro_torch.testing import faults

_I32_MAX = torch.iinfo(torch.int32).max
_I32_MIN = torch.iinfo(torch.int32).min


def check_mesh_matches(part: Partition2D, mesh: ProcessMesh) -> None:
    """Raise unless ``part`` was cut for ``mesh``'s grid."""
    if (mesh.pr, mesh.pc) != (part.pr, part.pc):
        raise ValueError(f"mesh grid {(mesh.pr, mesh.pc)} != partition grid "
                         f"{(part.pr, part.pc)}")
    if mesh.pods not in (1, part.pods):
        raise ValueError(f"mesh pod axis {mesh.pods} incompatible with "
                         f"partition pods={part.pods}")


def _hash_keys(n: int, device) -> torch.Tensor:
    """Alg 1's per-vertex keys: the uint32 hash in int32 order."""
    h = hash32(torch.arange(n, device=device))
    return (h - (1 << 31)).to(torch.int32)


def _select_reduce(mesh, rl, cl, valid, keys, n, n_seg: int,
                   max_degree: int, site=None):
    """Alg 1's sharded reductions over one rank's edges (global ids,
    padding ``>= n_seg``): degree psum, key pmin, id pmin. Returns
    ``(cand, best_key, best_id)``, all ``[n_seg]`` and replicated."""
    dev = rl.device
    ud = mesh.psum(segment_sum(valid.to(torch.int32), rl, n_seg))
    cand = (ud <= max_degree) & (torch.arange(n_seg, device=dev) < n)
    ok = valid & take_fill(cand, cl, False)
    k = torch.where(ok, take_fill(keys, cl, _I32_MAX), _I32_MAX)
    if site is not None:
        k = site(k)
    best_k = mesh.pmin(segment_min(k, rl, n_seg))
    attain = ok & (k == take_fill(best_k, rl, _I32_MIN))
    ids = torch.where(attain, cl.to(torch.int32), _I32_MAX)
    best_id = mesh.pmin(segment_min(ids, rl, n_seg))
    return cand, best_k, best_id


def _strict_min(cand, keys, best_k, best_id):
    """Eliminate a candidate iff it beats every candidate neighbour."""
    iota = torch.arange(keys.shape[0], device=keys.device)
    lt = (keys < best_k) | ((keys == best_k) & (iota < best_id))
    return cand & lt


# ----------------------------------------------------------------------------
# Partition-level primitives
# ----------------------------------------------------------------------------

def _globalize(mesh: ProcessMesh, part: Partition2D):
    blk = rank_block(part, mesh.block, mesh.device)
    return blk["row"] < part.n_pad, blk["row"], blk["col"]


def distributed_unweighted_degrees(mesh: ProcessMesh,
                                   part: Partition2D) -> torch.Tensor:
    """int32 [n_pad] unweighted degrees, replicated (one psum)."""
    check_mesh_matches(part, mesh)
    valid, row_g, _ = _globalize(mesh, part)
    return mesh.psum(segment_sum(valid.to(torch.int32), row_g, part.n_pad))


def distributed_select_eliminated(mesh: ProcessMesh, part: Partition2D,
                                  n: int, max_degree: int = 4
                                  ) -> torch.Tensor:
    """Alg 1 selection over the 2D partition. Returns bool [n_pad].

    Matches ``core.elimination.select_eliminated`` on the first n entries;
    padding vertices (degree 0) are never candidates.
    """
    check_mesh_matches(part, mesh)
    valid, row_g, col_g = _globalize(mesh, part)
    keys = _hash_keys(part.n_pad, mesh.device)
    cand, best_k, best_id = _select_reduce(mesh, row_g, col_g, valid, keys,
                                           n, part.n_pad, max_degree)
    return _strict_min(cand, keys, best_k, best_id)


def _pad_to(x: torch.Tensor, n_pad: int, tail: torch.Tensor) -> torch.Tensor:
    extra = n_pad - x.shape[0]
    if extra == 0:
        return x
    return torch.cat([x, tail[:extra].to(x.dtype)])


def distributed_vote_round(mesh: ProcessMesh, part: Partition2D, n: int,
                           strength_q, state, votes, aggregates,
                           cfg: AggregationConfig = AggregationConfig()):
    """One Alg 2 voting round over the 2D partition.

    ``strength_q`` is the per-edge quantised strength in the partition's
    [pods, pr, pc, cap] layout (numpy or tensor); ``state``/``votes``/
    ``aggregates`` are length-n (or n_pad) int32 vertex tensors on the
    mesh's device. Returns the updated [n_pad] triple; the first n
    entries bit-match ``core.aggregation.aggregation_round``.
    """
    check_mesh_matches(part, mesh)
    dev, n_pad = mesh.device, part.n_pad
    # padding vertices are Decided with no votes: they never emit (⊗ drops
    # Decided), never join, and never get voted for (no incident edges)
    state = _pad_to(state.to(torch.int32), n_pad,
                    torch.full((n_pad,), DECIDED, device=dev))
    votes = _pad_to(votes.to(torch.int32), n_pad,
                    torch.zeros(n_pad, device=dev))
    aggregates = _pad_to(aggregates.to(torch.int32), n_pad,
                         torch.arange(aggregates.shape[0], n_pad,
                                      device=dev))
    valid, row_g, col_g = _globalize(mesh, part)
    p, i, j = mesh.block
    sq = torch.as_tensor(strength_q)[p, i, j].to(dev, torch.int32)
    nbr_state = take_fill(state, col_g, DECIDED)
    ok = valid & (nbr_state != DECIDED)
    key = _pack_state_strength(nbr_state, sq, cfg.strength_levels)
    k = torch.where(ok, key, _I32_MIN)
    best_k = mesh.pmax(segment_max(k, row_g, n_pad))
    attain = ok & (k == take_fill(best_k, row_g, _I32_MAX))
    ids = torch.where(attain, col_g.to(torch.int32), _I32_MAX)
    best_id = mesh.pmin(segment_min(ids, row_g, n_pad))
    # the replicated state update: the exact code the serial round runs
    return apply_vote_update(state, votes, aggregates, best_k, best_id, cfg)


def distributed_aggregate(mesh: ProcessMesh, part: Partition2D, n: int,
                          strength_q,
                          cfg: AggregationConfig = AggregationConfig()):
    """All of Alg 2 over the partition: ``cfg.n_rounds`` voting rounds,
    then the replicated singleton/seed finalisation. Returns
    ``(aggregates, state)`` [n_pad]; the first ``n`` bit-match the serial
    ``aggregate``."""
    n_pad, dev = part.n_pad, mesh.device
    iota = torch.arange(n_pad, dtype=torch.int32, device=dev)
    state = torch.where(iota < n, UNDECIDED, DECIDED).to(torch.int32)
    votes = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    aggregates = iota
    for _ in range(cfg.n_rounds):
        state, votes, aggregates = distributed_vote_round(
            mesh, part, n, strength_q, state, votes, aggregates, cfg)
    # leftover Undecided vertices become singletons; seeds anchor themselves
    aggregates = torch.where((state == UNDECIDED) | (state == SEED), iota,
                             aggregates)
    return aggregates, state


# ============================================================================
# The distributed super-step setup: collective hooks for the bucketed loop.
# ============================================================================

def _rank_slice(x: torch.Tensor, mesh: ProcessMesh, blk: int, fill):
    """This rank's ``blk``-long slice of a carry array cut into
    ``mesh.size`` equal contiguous blocks (padded with ``fill``). A
    single-rank mesh takes the whole array as it is."""
    if mesh.size == 1 and x.shape[0] == blk:
        return x
    lo = mesh.shard_index * blk
    s = x[lo:lo + blk]
    pad = blk - s.shape[0]
    if pad:
        s = torch.cat([s, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                     dtype=x.dtype, device=x.device)])
    # a copy of its own: a row-block view may start off the 16-byte
    # alignment the kernels' bulk copies need
    return s.clone()


def edge_block_counts(mesh: ProcessMesh, row: torch.Tensor,
                      n_cap: int) -> torch.Tensor:
    """Real edges per block of a carry's partition into ``mesh.size``
    equal contiguous slices, as int32 ``[pods, pr, pc]``: a diagnostics
    helper (the setup never needs it; equal slices of a coalesced carry
    are balanced by construction). ``row`` is replicated, so every rank
    gets every block's count."""
    size = mesh.size
    blk = -(-row.shape[0] // size)
    pad = blk * size - row.shape[0]
    if pad:
        row = torch.cat([row, row.new_full((pad,), n_cap)])
    counts = (row.reshape(size, blk) < n_cap).sum(dim=1, dtype=torch.int32)
    return counts.reshape(mesh.pods, mesh.pr, mesh.pc)


def _shard_site(name: str, mesh: ProcessMesh):
    return lambda t: faults.site_traced(name, t, axis_index=mesh.shard_index,
                                        n_shards=mesh.size)


def _dist_select_fn(mesh: ProcessMesh, n_cap: int, e_cap: int,
                    max_degree: int):
    """Sharded Alg 1 selection over the carry's edge blocks: three
    all-reduces (degree psum, key pmin, id pmin), integer ⊕ throughout,
    so the result is the serial selection's bit for bit on any mesh. The
    returned function is one build of the ``dist.select`` site."""
    keys = _hash_keys(n_cap, mesh.device)
    build = faults.TracedBuild()
    site = _shard_site("dist.select", mesh)

    def fn(row, col, val, deg, n):
        blk = -(-row.shape[0] // mesh.size)
        rl = _rank_slice(row, mesh, blk, n_cap)
        cl = _rank_slice(col, mesh, blk, n_cap)
        with build.run():
            cand, best_k, best_id = _select_reduce(
                mesh, rl, cl, rl < n_cap, keys, n, n_cap, max_degree,
                site=site)
        return _strict_min(cand, keys, best_k, best_id)

    return fn


def _dist_vote_factory(mesh: ProcessMesh, n_cap: int, cfg):
    """Sharded Alg 2 vote ⊕ for the agg super-step.

    Each rank runs the ``agg_vote`` kernel on its *row block* of the vote
    layout (ELL rows are complete, so a row's ⊕ needs no cross-rank
    combine) and the staged reduction on its slice of the COO spill; the
    partials lex-merge through one pmax (keys) and one pmin (ids) per
    round, the paper's column-reduce + row-broadcast pair. Bit-identical
    to the serial ``vote_edge_reduce`` (integer ⊕). The factory is one
    build of the ``dist.vote`` site."""
    acfg = cfg.aggregation
    size, idx = mesh.size, mesh.shard_index
    rblk = -(-n_cap // size)
    n_rows_pad = rblk * size
    lo = idx * rblk
    build = faults.TracedBuild()
    site = _shard_site("dist.vote", mesh)

    def factory(lay, sq_table, sq_spill):
        from repro_torch.kernels.agg_vote import vote_reduce

        e_cap = lay.spill_row.shape[0]
        eblk = -(-e_cap // size)
        # the rank's row block, contiguous once per level (not per round)
        ec = _rank_slice(lay.col_table, mesh, rblk, n_cap)
        es = _rank_slice(sq_table, mesh, rblk, 0)
        srl = _rank_slice(lay.spill_row, mesh, eblk, n_cap)
        scl = _rank_slice(lay.spill_col, mesh, eblk, n_cap)
        ssl = _rank_slice(sq_spill, mesh, eblk, 0)
        dev = ec.device

        def edge_reduce(state):
            with build.run():
                bk_r, bi_r = vote_reduce(ec, es, state,
                                         levels=acfg.strength_levels,
                                         decided=DECIDED)
                bk_r = site(bk_r)
            key_part = torch.full((n_rows_pad,), _I32_MIN, dtype=torch.int32,
                                  device=dev)
            key_part[lo:lo + rblk] = bk_r
            nbr = take_fill(state, scl, DECIDED)
            ok = (srl < n_cap) & (nbr != DECIDED)
            k = torch.where(ok, _pack_state_strength(nbr, ssl,
                                                     acfg.strength_levels),
                            _I32_MIN)
            seg = torch.where(ok, srl, n_rows_pad)
            gk = mesh.pmax(torch.maximum(key_part,
                                         segment_max(k, seg, n_rows_pad)))
            own = gk[lo:lo + rblk]
            id_part = torch.full((n_rows_pad,), _I32_MAX, dtype=torch.int32,
                                 device=dev)
            id_part[lo:lo + rblk] = torch.where(bk_r == own, bi_r, _I32_MAX)
            attain = ok & (k == take_fill(gk, seg, _I32_MAX))
            sids = torch.where(attain, scl.to(torch.int32), _I32_MAX)
            gi = mesh.pmin(torch.minimum(id_part,
                                         segment_min(sids, seg, n_rows_pad)))
            return gk[:n_cap], gi[:n_cap]

        return edge_reduce

    return factory


class DistSuperstepBuilders(SuperstepBuilders):
    """Mesh-tagged super-step steps: Alg 1 selection and the Alg 2 vote
    rounds run as collectives over the carry's edge and row blocks;
    everything else inherits the serial builders (the replicated float
    stages: the equivalence contract). Registry keys carry the mesh, so
    per-mesh entries coexist with the serial ones and the miss/call/
    host-fetch counters are shared.

    The fault trace token rides the tag: while a plan with traced sites
    is armed, each setup gets its own registry entries (new builds of
    ``dist.select``/``dist.vote``), never reusing a clean entry nor
    leaving an armed one behind for clean setups. In production the token
    is None and the tag is constant."""

    def __init__(self, cfg, mesh: ProcessMesh):
        super().__init__(cfg, mesh.device)
        self.mesh = mesh
        self.tag = (mesh, faults.trace_token())

    def select_fn(self, n_cap: int, e_cap: int):
        return _dist_select_fn(self.mesh, n_cap, e_cap,
                               self.cfg.elim_max_degree)

    def vote_factory(self, n_cap: int, e_cap: int):
        return _dist_vote_factory(self.mesh, n_cap, self.cfg)


def build_hierarchy_superstep_dist(adj, cfg, mesh: ProcessMesh,
                                   profile: list | None = None):
    """The bucketed super-step setup with the semiring reductions sharded
    over ``mesh``'s 2D edge partition: the serial super-step's hierarchy
    bit for bit, with one batched host fetch per constructed level.
    ``adj`` lives on ``mesh.device``."""
    return build_hierarchy_superstep(adj, cfg, profile=profile,
                                     steps=DistSuperstepBuilders(cfg, mesh))
