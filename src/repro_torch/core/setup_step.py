"""Bucket-padded multigrid setup whose steps never make the host wait
(torch port of ``repro.core.setup_step``).

The eager loop (``core.hierarchy.build_hierarchy_eager``) reads counts
back to the host inside every stage: the eliminated count, the coarse
size, every level's nnz, and the histograms and masks of its sorts. Here
the per-level work runs as a handful of *steps* whose shapes depend only
on power-of-two capacity buckets, never on exact level sizes:

* ``elim``        — Alg 1 selection fused with the Schur-complement level
  (the default ``elim_sizing="conservative"``: F-slot arrays sized at the
  vertex bucket, so no count separates selection from construction and an
  elimination level costs ONE host fetch),
* ``elim_select`` / ``elim_build`` — the two-fetch split of the same work
  (``elim_sizing="exact"``: F-slots sized at ``bucket(n_elim)``),
* ``agg``         — strength sweeps, the Alg 2 vote rounds through the
  ``agg_vote`` kernel (overlong rows through the staged reduction, merged
  exactly), renumbering, contraction and the λmax power iteration,
* ``rebucket``    — shrink the carry to the next level's buckets,
* ``ingest`` / ``ingest_fast`` — the padded finest level and its degrees
  (``ingest`` first moves the real entries of an arbitrary-order input to
  the front with a stable partition; ``ingest_fast`` takes inputs whose
  padding is already last, as any coalesce output's is), after the
  ``probe`` that tells the two apart.

A level of ``n`` vertices and ``nnz`` edges is carried as arrays padded to
``(bucket(n), bucket(nnz))``, with ``n`` a 0-d tensor on the device.
Padding vertices are isolated (degree 0, sentinel edge ids ``== n_cap``)
and masked by ``n_valid`` where isolated vertices behave differently:
elimination candidacy, the vote state's start, the renumbering roots, and
the strength and λmax means. The host waits only in :func:`_fetch`: once
per constructed level (its count and nnz, one batched copy), once for the
entry probe and once for the coarse solve at the end. Unlike the
reference, the ``agg`` step also counts Alg 1's selection on the level it
builds; the count rides in that step's fetch, so an elimination pass it
rejects costs neither a step nor a fetch (the reference pays one of each).
Under ``torch.cuda.set_sync_debug_mode("error")`` any other wait that
PyTorch detects raises (its detection is a prototype: not every
synchronising call is seen); ``_fetch`` and the host work after the last
fetch lift the mode.

**The registry.** PyTorch compiles nothing, so a registry entry is the
step function for one ``(step, bucket key)``. The constants that depend
only on the bucket (the strength sweeps' ``(n_cap, R)`` uniform draw and
the λmax start vector) are drawn once per bucket and shared by its
entries, the batched ones included. ``counters()["steps"][name]
["compiles"]`` counts registry misses under the reference's name, where a
miss was one XLA compile; a second graph whose levels land in the same
buckets adds no entry. Steps look up the kernel wrappers when they run,
so a wrapper rebound after an entry was built is still the one called.

**The plan.** The loop is written once, as a generator
(:func:`_setup_plan`) that yields step and fetch requests.
:func:`build_hierarchy_superstep` drives one plan.
:func:`build_hierarchy_superstep_batch` drives N in lockstep rounds:
requests for the same ``(step, bucket key)`` run through one registry
entry ``<name>@batch``, the step's stacked form over the group (what the
reference's ``jax.vmap`` makes of it on an accelerator: one launch of each
kernel for the G graphs, the vote rounds through the graph-batched
``agg_vote`` kernel), and every plan waiting on host scalars shares one
fetch a round. Each graph's slice of a stacked step is bit for bit its
single-graph step's, so each hierarchy of a batch is bit-identical to its
own build. Builders with a semiring hook (the distributed ones) run a
group's members in turn instead (the reference's CPU ``unroll``
lowering). Both setups give the eager loop's hierarchy: the same levels,
aggregates and elimination masks, and bitwise the same PCG residuals
(every float sum runs over the same entries in the same order, whatever
the padding).
"""

from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.core.aggregation import (aggregate, aggregate_groups,
                                          quantise_strength, renumber_device,
                                          renumber_device_groups,
                                          vote_edge_reduce,
                                          vote_edge_reduce_groups)
from repro_torch.core.coarsen import (AggregationLevel, contract_arrays,
                                      contract_arrays_groups)
from repro_torch.core.elimination import (EliminationLevel, schur_arrays,
                                          schur_arrays_groups,
                                          select_eliminated,
                                          select_eliminated_groups)
from repro_torch.core.graph import (GraphLevel, GroupLevel,
                                    attach_setup_twin,
                                    attach_setup_twin_groups, count_tensor,
                                    graph_from_adjacency, pow2_bucket)
from repro_torch.core.prng import normal, uniform
from repro_torch.core.smoothers import (estimate_lambda_max,
                                        estimate_lambda_max_groups)
from repro_torch.core.strength import (STRENGTH_METRICS,
                                       STRENGTH_METRICS_GROUPS)
from repro_torch.sparse.coo import COO
from repro_torch.sparse.ell import ell_layout_groups, ell_layout_traced
from repro_torch.sparse.segment import segment_sum, segment_sum_groups
from repro_torch.testing import faults


# ----------------------------------------------------------------------------
# Step registry: one step function (and its constants) per (step, bucket key).
# ----------------------------------------------------------------------------

_CACHE: dict = {}
_CONSTANTS: dict = {}   # (device, n_cap, seed, R) -> the bucket's draws
_STATS: dict = {}       # step name -> {"compiles": int, "calls": int}
_SYNCS = [0]            # batched host fetches since the last reset
_I32_MAX = torch.iinfo(torch.int32).max


def reset_counters() -> None:
    """Zero the miss/call/host-sync counters (the registry stays)."""
    _STATS.clear()
    _SYNCS[0] = 0


def clear_cache() -> None:
    """Drop every registry entry and the device constants it holds."""
    _CACHE.clear()
    _CONSTANTS.clear()


def counters() -> dict:
    """Snapshot: per-step ``{"compiles", "calls"}`` plus batched host
    fetches since the last :func:`reset_counters`. ``compiles`` counts
    registry misses: a miss builds the step and its bucket's constants, a
    hit reuses them."""
    return dict(steps={k: dict(v) for k, v in _STATS.items()},
                host_syncs=_SYNCS[0])


def _step(name: str, key, builder):
    st = _STATS.setdefault(name, dict(compiles=0, calls=0))
    st["calls"] += 1
    fn = _CACHE.get((name, key))
    if fn is None:
        st["compiles"] += 1
        fn = _CACHE[(name, key)] = builder()
    return fn


@contextlib.contextmanager
def _host_work(device: torch.device):
    """Within the block, a sync debug mode set by the caller
    (``torch.cuda.set_sync_debug_mode``) is lifted: the block is one of
    the setup's host waits, or host work after the last of them."""
    if device.type != "cuda":
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _fetch(*vals: torch.Tensor) -> tuple:
    """One batched host wait for this decision point: every value is
    copied to pinned host memory on the current stream, then the host
    waits once. Returns host tensors."""
    _SYNCS[0] += 1
    cuda = [v for v in vals if v.is_cuda]
    if not cuda:
        return vals
    dev = cuda[0].device
    with _host_work(dev):
        out = []
        for v in vals:
            if v.is_cuda:
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                v = h.copy_(v, non_blocking=True)
            out.append(v)
        torch.cuda.current_stream(dev).synchronize()
    return tuple(out)


def bucket(n: int, floor: int = 0) -> int:
    """Round up to the next power of two, with an optional floor.

    The floor (``SetupConfig.setup_bucket_floor``, itself a power of two)
    widens reuse: every level smaller than the floor shares the
    floor-sized entries. Delegates to ``graph.pow2_bucket``, the one
    bucket rule shared with the strength/λmax padding and the eager
    path's capacity shrink (the eager/super-step bit-identity depends on
    these agreeing).
    """
    return pow2_bucket(n, floor)


# ----------------------------------------------------------------------------
# Step builders. Each returns a step function whose shapes are fixed by the
# bucket key; logical sizes ride as 0-d device tensors.
# ----------------------------------------------------------------------------

def _plevel(row, col, val, deg) -> GraphLevel:
    """Bucket-padded arrays as a GraphLevel of n_cap vertices, the padding
    isolated (sentinel ids == n_cap keep every segment reduction exact)."""
    n_cap = deg.shape[0]
    return GraphLevel(adj=COO(row, col, val, n_cap, n_cap), deg=deg)


def _pad(row, col, val, cap: int, sentinel: int):
    """Extend an edge list to ``cap`` entries with sentinel padding."""
    pad = cap - row.shape[0]
    full = torch.full((pad,), sentinel, dtype=torch.int32, device=row.device)
    return (torch.cat([row, full]), torch.cat([col, full]),
            torch.cat([val, val.new_zeros(pad)]))


def _ingest_probe(row, n0):
    """(nnz, padding-last?) of a raw edge list: the scalar pair that
    decides between ``ingest_fast`` and ``ingest``. A plain function (a
    single build keeps it out of the registry, as the reference does)."""
    valid = row < n0
    nnz = valid.sum()
    iota = torch.arange(row.shape[0], device=row.device)
    return nnz, (valid == (iota < nnz)).all()


def _build_probe(raw_cap: int):
    """Registry form of the ingest probe, for the batched build."""
    return _ingest_probe


def _build_ingest_fast(raw_cap: int, n_cap: int, e_cap: int):
    """Inputs already in padding-last layout: renormalise sentinels to the
    carry's convention and resize ``raw_cap -> e_cap`` with a slice or a
    pad."""
    def step(row, col, val, n0):
        valid = row < n0
        r = torch.where(valid, row, n_cap).to(torch.int32)
        c = torch.where(valid, col, n_cap).to(torch.int32)
        v = torch.where(valid, val, 0)
        if e_cap <= raw_cap:
            # sound only for padding-last inputs (the probe checked)
            r, c, v = r[:e_cap], c[:e_cap], v[:e_cap]
        else:
            r, c, v = _pad(r, c, v, e_cap, n_cap)
        return r, c, v, segment_sum(v, r, n_cap)

    return step


def _build_ingest(raw_cap: int, n_cap: int, e_cap: int):
    """Arbitrary-order inputs: a stable partition moves the real entries
    to the front in their input order (the reference's host compaction,
    done on the device), then as ``ingest_fast``."""
    fast = _build_ingest_fast(raw_cap, n_cap, e_cap)

    def step(row, col, val, n0):
        order = torch.argsort((row >= n0).to(torch.int32), stable=True)
        return fast(row[order], col[order], val[order], n0)

    return step


def _schur(row, col, val, deg, elim, n, f_cap: int, max_degree: int):
    """``schur_arrays`` on a padded level, with the coarse degrees the
    carry takes to the next level."""
    n_cap = deg.shape[0]
    w = max_degree
    out = schur_arrays(COO(row, col, val, n_cap, n_cap), deg, elim, n,
                       f_cap=f_cap, max_degree=max_degree,
                       out_capacity=row.shape[0] + f_cap * w * w,
                       sentinel=n_cap)
    out["co_deg"] = segment_sum(out["co_val"], out["co_row"], n_cap)
    return out


def _select(row, col, val, deg, n, max_degree: int, select_fn):
    if select_fn is None:
        return select_eliminated(_plevel(row, col, val, deg), max_degree,
                                 n_valid=n)
    return select_fn(row, col, val, deg, n)


def _build_elim_select(n_cap: int, e_cap: int, max_degree: int,
                       select_fn=None):
    def step(row, col, val, deg, n):
        elim = _select(row, col, val, deg, n, max_degree, select_fn)
        return elim, elim.sum()

    return step


def _build_elim_build(n_cap: int, e_cap: int, f_cap: int, max_degree: int):
    # the Schur fill cliques come from an [n_cap, max_degree] neighbour
    # table: its width must cover the selection rule's degree bound
    def step(row, col, val, deg, n, elim):
        return _schur(row, col, val, deg, elim, n, f_cap, max_degree)

    return step


def _build_elim_fused(n_cap: int, e_cap: int, max_degree: int,
                      select_fn=None):
    """Selection + Schur construction as ONE step (the default
    ``elim_sizing="conservative"``): F-slot arrays are sized at the vertex
    bucket, a capacity that never depends on the eliminated count, so no
    host fetch separates the two phases and the whole elimination level
    costs one fetch (count + coarse nnz, after the fact)."""
    def step(row, col, val, deg, n):
        elim = _select(row, col, val, deg, n, max_degree, select_fn)
        return elim, _schur(row, col, val, deg, elim, n, n_cap, max_degree)

    return step


def _lam_seed_vector(n_cap: int, device) -> torch.Tensor:
    """The λmax power-iteration start vector of a vertex bucket (seed 0,
    ``estimate_lambda_max``'s default)."""
    return normal(0, (n_cap,), device)


def _agg_constants(n_cap: int, cfg, device) -> tuple:
    """A vertex bucket's constants: the strength sweeps' ``(n_cap, R)``
    uniform draw and the λmax start vector, drawn once per (device,
    bucket, seed, R) and shared by every registry entry of that bucket,
    its batched entries included (a group broadcasts them)."""
    key = (torch.device(device), n_cap, cfg.seed, cfg.strength_vectors)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = (uniform(cfg.seed, (n_cap, cfg.strength_vectors),
                                   -0.5, 0.5, device),
                           _lam_seed_vector(n_cap, device))
    return _CONSTANTS[key]


def _build_agg(n_cap: int, e_cap: int, cfg, device, vote_factory=None,
               select_fn=None):
    strength_fn = STRENGTH_METRICS[cfg.strength_metric]
    acfg = cfg.aggregation
    x0, lam_v0 = _agg_constants(n_cap, cfg, device)

    def step(row, col, val, deg, n):
        level = _plevel(row, col, val, deg)
        # one ELL layout serves the vote kernel's tables and, with
        # setup_ell_sweeps, the strength and λmax SpMVs' twin
        lay = ell_layout_traced(row, col, n_cap, cfg.setup_ell_width)
        if cfg.ell_sweeps:
            level = attach_setup_twin(level, lay)
        strength = strength_fn(level, n_vectors=cfg.strength_vectors,
                               n_sweeps=cfg.strength_sweeps, seed=cfg.seed,
                               n_valid=n, x0=x0)
        # quantised strengths in the vote layout, built once and reused by
        # every round (only the state vector changes)
        sq = quantise_strength(strength, acfg)
        sq_table, sq_spill = lay.table(sq), lay.spill(sq)
        if vote_factory is None:
            def edge_reduce(state):
                return vote_edge_reduce(lay, sq_table, sq_spill, state, acfg)
        else:
            edge_reduce = vote_factory(lay, sq_table, sq_spill)
        aggs, _state = aggregate(level, None, acfg, n_valid=n,
                                 edge_reduce=edge_reduce)
        coarse_id, n_c, ok = renumber_device(aggs, n_valid=n)
        co_row, co_col, co_val, co_nnz = contract_arrays(
            level.adj, coarse_id, n_c, sentinel=n_cap)
        co_deg = segment_sum(co_val, co_row, n_cap)
        # Alg 1's count on the coarse level, for the elimination pass that
        # follows: it rides in this step's fetch, so a pass it rejects
        # costs no step and no fetch of its own
        next_elim = _select(co_row, co_col, co_val, co_deg, n_c,
                            cfg.elim_max_degree, select_fn)
        return dict(coarse_id=coarse_id, n_c=n_c, ok=ok, co_row=co_row,
                    co_col=co_col, co_val=co_val, co_deg=co_deg,
                    co_nnz=co_nnz, n_elim_next=next_elim.sum(),
                    lam=estimate_lambda_max(level, n_valid=n, v0=lam_v0))

    step.constants = (x0, lam_v0)
    return step


def _build_rebucket(n_from: int, e_from: int, n_to: int, e_to: int):
    def step(row, col, val, deg):
        if e_to <= e_from:
            r, c, v = row[:e_to], col[:e_to], val[:e_to]
        else:
            r, c, v = _pad(row, col, val, e_to, n_from)
        r = torch.where(r >= n_to, n_to, r).to(torch.int32)
        c = torch.where(c >= n_to, n_to, c).to(torch.int32)
        return r, c, v, deg[:n_to]

    return step


# ----------------------------------------------------------------------------
# Stacked step builders (the batched setup): each step over a group of G
# same-bucket levels at once, what the reference's ``jax.vmap`` makes of it
# on an accelerator. Arguments and results carry a leading graph axis (the
# counts are [G] tensors); every graph keeps its own ids, sentinel n_cap and
# padding-last edge blocks, so graph g's slice of each result is bit for bit
# its single-graph step's: integer work is per row or per segment, every
# sort is stable and keyed (graph, row, col), every float segment sum adds
# the entries it has alone in the same order, and the few whole-vector
# float sums (the strength and λmax means and norms) run a graph at a time.
# ----------------------------------------------------------------------------

def _pad_groups(row, col, val, cap: int, sentinel: int):
    """:func:`_pad` of every graph of a group."""
    g, pad = row.shape[0], cap - row.shape[1]
    full = torch.full((g, pad), sentinel, dtype=torch.int32,
                      device=row.device)
    return (torch.cat([row, full], 1), torch.cat([col, full], 1),
            torch.cat([val, val.new_zeros((g, pad))], 1))


def _ingest_probe_groups(row, n0):
    valid = row < n0[:, None]
    nnz = valid.sum(1)
    iota = torch.arange(row.shape[1], device=row.device)
    return nnz, (valid == (iota < nnz[:, None])).all(1)


def _build_ingest_fast_groups(raw_cap: int, n_cap: int, e_cap: int):
    def step(row, col, val, n0):
        valid = row < n0[:, None]
        r = torch.where(valid, row, n_cap).to(torch.int32)
        c = torch.where(valid, col, n_cap).to(torch.int32)
        v = torch.where(valid, val, 0)
        if e_cap <= raw_cap:
            r, c, v = (t[:, :e_cap].contiguous() for t in (r, c, v))
        else:
            r, c, v = _pad_groups(r, c, v, e_cap, n_cap)
        return r, c, v, segment_sum_groups(v, r, n_cap)

    return step


def _build_ingest_groups(raw_cap: int, n_cap: int, e_cap: int):
    fast = _build_ingest_fast_groups(raw_cap, n_cap, e_cap)

    def step(row, col, val, n0):
        order = torch.argsort((row >= n0[:, None]).to(torch.int32), dim=1,
                              stable=True)
        return fast(row.gather(1, order), col.gather(1, order),
                    val.gather(1, order), n0)

    return step


def _schur_groups(row, col, val, deg, elim, n, f_cap: int, max_degree: int):
    n_cap = deg.shape[1]
    w = max_degree
    out = schur_arrays_groups(row, col, val, deg, elim, n, f_cap=f_cap,
                              max_degree=max_degree,
                              out_capacity=row.shape[1] + f_cap * w * w,
                              sentinel=n_cap)
    out["co_deg"] = segment_sum_groups(out["co_val"], out["co_row"], n_cap)
    return out


def _build_elim_select_groups(n_cap: int, e_cap: int, max_degree: int):
    def step(row, col, val, deg, n):
        elim = select_eliminated_groups(row, col, n_cap, n, max_degree)
        return elim, elim.sum(1)

    return step


def _build_elim_build_groups(n_cap: int, e_cap: int, f_cap: int,
                             max_degree: int):
    def step(row, col, val, deg, n, elim):
        return _schur_groups(row, col, val, deg, elim, n, f_cap, max_degree)

    return step


def _build_elim_fused_groups(n_cap: int, e_cap: int, max_degree: int):
    def step(row, col, val, deg, n):
        elim = select_eliminated_groups(row, col, n_cap, n, max_degree)
        return elim, _schur_groups(row, col, val, deg, elim, n, n_cap,
                                   max_degree)

    return step


def _build_agg_groups(n_cap: int, e_cap: int, cfg, device):
    strength_fn = STRENGTH_METRICS_GROUPS[cfg.strength_metric]
    acfg = cfg.aggregation
    x0, lam_v0 = _agg_constants(n_cap, cfg, device)

    def step(row, col, val, deg, n):
        level = GroupLevel(row, col, val, deg)
        lay = ell_layout_groups(row, col, n_cap, cfg.setup_ell_width)
        if cfg.ell_sweeps:
            level = attach_setup_twin_groups(level, lay)
        strength = strength_fn(level, n_vectors=cfg.strength_vectors,
                               n_sweeps=cfg.strength_sweeps, seed=cfg.seed,
                               n_valid=n, x0=x0)
        sq = quantise_strength(strength, acfg)
        sq_table, sq_spill = lay.table(sq), lay.spill(sq)

        def edge_reduce(state):
            # ONE graph-batched vote launch a round for the whole group
            return vote_edge_reduce_groups(lay, sq_table, sq_spill, state,
                                           acfg)

        aggs, _state = aggregate_groups(n, n_cap, edge_reduce, acfg)
        coarse_id, n_c, ok = renumber_device_groups(aggs, n)
        co_row, co_col, co_val, co_nnz = contract_arrays_groups(
            row, col, val, n_cap, coarse_id, n_c, sentinel=n_cap,
            out_capacity=row.shape[1])
        co_deg = segment_sum_groups(co_val, co_row, n_cap)
        next_elim = select_eliminated_groups(co_row, co_col, n_cap, n_c,
                                             cfg.elim_max_degree)
        return dict(coarse_id=coarse_id, n_c=n_c, ok=ok, co_row=co_row,
                    co_col=co_col, co_val=co_val, co_deg=co_deg,
                    co_nnz=co_nnz, n_elim_next=next_elim.sum(1),
                    lam=estimate_lambda_max_groups(level, n_valid=n,
                                                   v0=lam_v0))

    step.constants = (x0, lam_v0)
    return step


def _build_rebucket_groups(n_from: int, e_from: int, n_to: int, e_to: int):
    def step(row, col, val, deg):
        if e_to <= e_from:
            r, c, v = row[:, :e_to], col[:, :e_to], val[:, :e_to]
        else:
            r, c, v = _pad_groups(row, col, val, e_to, n_from)
        r = torch.where(r >= n_to, n_to, r).to(torch.int32)
        c = torch.where(c >= n_to, n_to, c).to(torch.int32)
        return r, c, v.contiguous(), deg[:, :n_to].contiguous()

    return step


def _group_extent(method: str, params: tuple, max_degree: int) -> tuple:
    """(vertex bucket, entries a graph) that a stacked step indexes."""
    if method == "probe":
        return 0, params[0]
    if method in ("ingest", "ingest_fast"):
        raw_cap, n_cap, e_cap = params
        return n_cap, max(raw_cap, e_cap)
    if method == "rebucket":
        n_from, e_from, n_to, e_to = params
        return max(n_from, n_to), max(e_from, e_to)
    n_cap, e_cap = params[:2]
    if method in ("elim", "elim_build"):
        f_cap = params[2] if method == "elim_build" else n_cap
        return n_cap, e_cap + f_cap * max_degree * max_degree
    return n_cap, e_cap


def check_group(method: str, params: tuple, n_graphs: int,
                max_degree: int) -> None:
    """Raise unless a group of ``n_graphs`` stacks within int32: the
    stacked vertex ids with each graph's sentinel (G·(n_cap + 1), the sort
    keys' and the vote kernel's row space) and the stacked entries."""
    n_cap, entries = _group_extent(method, params, max_degree)
    if n_graphs * (n_cap + 1) > _I32_MAX or n_graphs * entries > _I32_MAX:
        raise ValueError(
            f"a group of {n_graphs} graphs at {method}{params} does not "
            f"stack within int32 ({n_graphs}·(n_cap + 1) = "
            f"{n_graphs * (n_cap + 1)}, {n_graphs}·{entries} entries): "
            f"batch fewer graphs")


# ----------------------------------------------------------------------------
# Builder factory: the seam between the serial and a distributed setup,
# which would tag every registry key with its mesh and swap the two
# semiring-SpMV hooks for collective versions; the loop, the bucketing, the
# sync contract and the wrap stay shared.
# ----------------------------------------------------------------------------

class SuperstepBuilders:
    """Per-bucket step functions of one device, registry-cached."""

    tag: tuple = ()          # extra registry-key components

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)

    # -- hooks a distributed subclass overrides ---------------------------
    def select_fn(self, n_cap: int, e_cap: int):
        """Optional override of the Alg 1 selection reduction:
        ``(row, col, val, deg, n) -> elim`` or None for the serial
        ``select_eliminated``."""
        return None

    def vote_factory(self, n_cap: int, e_cap: int):
        """Optional override of the Alg 2 per-round edge ⊕:
        ``(layout, sq_table, sq_spill) -> (state -> (key, id))`` or None
        for the serial vote reduction."""
        return None

    # -- steps ------------------------------------------------------------
    # Every per-level step is addressed as ``(method, params)``, where
    # ``params`` is the bucket tuple; ``step`` resolves that address to a
    # registry entry: the single-graph step, or its batched form
    # (registered under ``<name>@batch``).

    def _key(self, method: str, params: tuple):
        cfg = self.cfg
        key = self.tag + (self.device,) + params
        if method == "agg":
            return key + (cfg.strength_metric, cfg.strength_vectors,
                          cfg.strength_sweeps, cfg.seed, cfg.aggregation,
                          cfg.setup_ell_width, cfg.elim_max_degree,
                          cfg.ell_sweeps and cfg.matvec_backend)
        if method in ("elim", "elim_select", "elim_build"):
            return key + (cfg.elim_max_degree,)
        return key

    def _make(self, method: str, params: tuple):
        md = self.cfg.elim_max_degree
        if method == "probe":
            return _build_probe(*params)
        if method == "ingest":
            return _build_ingest(*params)
        if method == "ingest_fast":
            return _build_ingest_fast(*params)
        if method == "elim":
            n_cap, e_cap = params
            return _build_elim_fused(n_cap, e_cap, md,
                                     select_fn=self.select_fn(n_cap, e_cap))
        if method == "elim_select":
            n_cap, e_cap = params
            return _build_elim_select(n_cap, e_cap, md,
                                      select_fn=self.select_fn(n_cap, e_cap))
        if method == "elim_build":
            n_cap, e_cap, f_cap = params
            return _build_elim_build(n_cap, e_cap, f_cap, md)
        if method == "agg":
            n_cap, e_cap = params
            return _build_agg(n_cap, e_cap, self.cfg, self.device,
                              vote_factory=self.vote_factory(n_cap, e_cap),
                              select_fn=self.select_fn(n_cap, e_cap))
        if method == "rebucket":
            return _build_rebucket(*params)
        raise KeyError(f"unknown super-step method {method!r}")

    def _make_groups(self, method: str, params: tuple):
        md = self.cfg.elim_max_degree
        if method == "probe":
            return _ingest_probe_groups
        if method == "ingest":
            return _build_ingest_groups(*params)
        if method == "ingest_fast":
            return _build_ingest_fast_groups(*params)
        if method == "elim":
            return _build_elim_fused_groups(*params, md)
        if method == "elim_select":
            return _build_elim_select_groups(*params, md)
        if method == "elim_build":
            return _build_elim_build_groups(*params, md)
        if method == "agg":
            return _build_agg_groups(*params, self.cfg, self.device)
        if method == "rebucket":
            return _build_rebucket_groups(*params)
        raise KeyError(f"unknown super-step method {method!r}")

    def _hooked(self) -> bool:
        """True when a subclass overrides a semiring hook (the
        distributed builders): its steps have no stacked form."""
        base = SuperstepBuilders
        return (type(self).select_fn is not base.select_fn
                or type(self).vote_factory is not base.vote_factory)

    def step(self, method: str, params: tuple, batch: int = 1):
        if batch == 1:
            if method == "probe":
                return _ingest_probe
            return _step(method, self._key(method, params),
                         lambda: self._make(method, params))
        key = self._key(method, params) + ("batch", batch)
        if self._hooked():
            return _step(method + "@batch", key + ("looped",),
                         lambda: _looped_program(self._make(method, params)))
        check_group(method, params, batch, self.cfg.elim_max_degree)
        return _step(method + "@batch", key, lambda: _batch_program(
            self._make_groups(method, params)))


# ----------------------------------------------------------------------------
# Exact-shape wrap (end of setup): slices of the carried arrays.
# ----------------------------------------------------------------------------

def _exact_coarse(spec: dict) -> GraphLevel:
    n_c, nnz_c = spec["n_c"], spec["nnz_c"]
    out = spec["out"]
    # no floor here: the wrapped levels take exact power-of-two capacities,
    # as the eager path's shrink gives them. Slice where the carry is
    # longer, pad where bucket(nnz) passes it (an elimination level's
    # coalesce output, e_cap + w²·f_cap long, is not a power of two).
    cap = bucket(max(nnz_c, 1))
    avail = out["co_row"].shape[0]
    take = min(cap, avail)           # the coalesce output is padding-last
    r = torch.clamp(out["co_row"][:take], max=n_c).to(torch.int32)
    c = torch.clamp(out["co_col"][:take], max=n_c).to(torch.int32)
    v = out["co_val"][:take]
    if cap > avail:
        r, c, v = _pad(r, c, v, cap, n_c)
    m = max(n_c, 1)
    return GraphLevel(adj=COO(r, c, v, m, m), deg=out["co_deg"][:m])


def _wrap_elim(fine: GraphLevel, spec: dict) -> EliminationLevel:
    n, n_f, n_c = spec["n"], spec["n_f"], spec["n_c"]
    out = spec["out"]
    pad = out["p_row"] >= n_f
    p_f = COO(torch.where(pad, n_f, out["p_row"]).to(torch.int32),
              torch.where(pad, n_f, out["p_col"]).to(torch.int32),
              out["p_val"], max(n_f, 1), max(n_c, 1))
    return EliminationLevel(
        fine=fine, coarse=_exact_coarse(spec), elim_mask=spec["elim"][:n],
        c_index=out["c_index"][:n], f_index=out["f_index"][:n],
        f_vertices=out["f_vertices"][:max(n_f, 1)].to(torch.int32),
        p_f=p_f, inv_deg_f=out["inv_deg_f"][:max(n_f, 1)])


def _wrap_agg(fine: GraphLevel, spec: dict) -> AggregationLevel:
    return AggregationLevel(fine=fine, coarse=_exact_coarse(spec),
                            coarse_id=spec["out"]["coarse_id"][:spec["n"]])


# ----------------------------------------------------------------------------
# The setup loop.
# ----------------------------------------------------------------------------

def _stack(ts: list) -> torch.Tensor:
    """The members' same-shape tensors as one ``[G, ...]`` tensor: a view
    where they are already consecutive slices of one tensor (the results
    of the group's previous stacked step), else one copy."""
    t0 = ts[0]
    n = t0.numel()
    base = t0.untyped_storage().data_ptr()
    if all(t.is_contiguous() and t.shape == t0.shape and t.dtype == t0.dtype
           and t.device == t0.device
           and t.untyped_storage().data_ptr() == base
           and t.storage_offset() == t0.storage_offset() + i * n
           for i, t in enumerate(ts)):
        return t0.as_strided((len(ts),) + tuple(t0.shape),
                             (n,) + tuple(t0.stride()), t0.storage_offset())
    return torch.stack(ts)


def _unstack(out, g: int) -> list:
    """Member g's slice of every tensor of a stacked result."""
    if isinstance(out, torch.Tensor):
        return [out[i] for i in range(g)]
    if isinstance(out, dict):
        parts = {k: _unstack(v, g) for k, v in out.items()}
        return [{k: parts[k][i] for k in out} for i in range(g)]
    parts = [_unstack(v, g) for v in out]
    return [tuple(p[i] for p in parts) for i in range(g)]


def _batch_program(fn):
    """A stacked step as a group's registry entry: it takes the list of
    the members' argument tuples, stacks each argument once, runs ``fn``
    once for the group and hands each member its slice of the results
    (the reference's ``jax.vmap`` lowering)."""
    def run(member_args):
        stacked = [_stack(list(a)) for a in zip(*member_args)]
        return _unstack(fn(*stacked), len(member_args))

    run.step = fn
    return run


def _looped_program(fn):
    """A single-graph step run for each member in turn (the reference's
    ``unroll`` lowering): the group form of a step with a semiring hook."""
    def run(member_args):
        return [fn(*args) for args in member_args]

    return run


def _validate_setup_cfg(cfg) -> None:
    floor = cfg.setup_bucket_floor
    if floor < 0 or (floor & (floor - 1)):
        # a floor that is not a power of two would give mixed buckets (no
        # reuse) and a padded strength/λmax state of another shape
        raise ValueError(f"setup_bucket_floor must be 0 or a power of two, "
                         f"got {floor!r}")
    if cfg.elim_sizing not in ("conservative", "exact"):
        raise ValueError(f"elim_sizing must be 'conservative' or 'exact', "
                         f"got {cfg.elim_sizing!r}")


def _elim_rejected(n_elim: int, n: int, cfg) -> bool:
    """An elimination pass that removes too few vertices (or all) is not
    taken."""
    return n_elim < max(cfg.elim_min_fraction * n, 1) or n_elim == n


def _setup_plan(adj: COO, cfg, profile: list | None = None):
    """The setup loop as a *plan*: a generator yielding execution
    requests, returning the finished ``Hierarchy`` via ``StopIteration``.

    Requests are ``("step", method, params, args)`` — run the registry
    step addressed by ``(method, params)`` on ``args`` — and ``("fetch",
    device_values)`` — one batched host wait. The caller sends the result
    back in. Keeping all device work and host waits behind requests is
    what lets the batched build run N plans in lockstep.
    """
    from repro_torch.core.hierarchy import (Hierarchy, attach_ell_transfers,
                                            coarse_inverse)

    floor = cfg.setup_bucket_floor
    dev = adj.device
    n0 = adj.n_rows
    raw_cap = adj.capacity
    n0_d = count_tensor(n0, dev)
    # entry ingest: the probe's scalar pair picks the padding-last fast
    # path (any coalesce output qualifies) or the stable partition
    probe = yield ("step", "probe", (raw_cap,), (adj.row, n0_d))
    nnz0, plast = yield ("fetch", tuple(probe))
    nnz0 = int(nnz0)
    n_cap, e_cap = bucket(n0, floor), bucket(max(nnz0, 1), floor)
    row_d, col_d, val_d, deg_d = yield (
        "step", "ingest_fast" if bool(plast) else "ingest",
        (raw_cap, n_cap, e_cap), (adj.row, adj.col, adj.val, n0_d))

    cur_n = n0
    n_d = n0_d
    specs: list = []
    next_elim = None     # Alg 1's count on the level an agg step just built

    def advance(out_row, out_col, out_val, out_deg, n_c, nnz_c):
        # a nested generator (entered with ``yield from``) so the rebucket
        # step is executed by the plan's caller like every other one
        nonlocal row_d, col_d, val_d, deg_d, n_cap, e_cap, cur_n, n_d
        n_to, e_to = bucket(n_c, floor), bucket(max(nnz_c, 1), floor)
        e_from = out_row.shape[0]
        if (n_to, e_to) != (n_cap, e_from):
            out_row, out_col, out_val, out_deg = yield (
                "step", "rebucket", (n_cap, e_from, n_to, e_to),
                (out_row, out_col, out_val, out_deg))
        row_d, col_d, val_d, deg_d = out_row, out_col, out_val, out_deg
        n_cap, e_cap, cur_n = n_to, e_to, n_c
        n_d = count_tensor(cur_n, dev)

    def tick():
        if profile is None:
            return None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    while cur_n > cfg.coarsest_size and len(specs) < cfg.max_levels:
        progressed = False

        # --- low-degree elimination pass(es) ---------------------------
        for _ in range(cfg.elim_rounds_per_level):
            if cur_n <= cfg.coarsest_size:
                break
            known, next_elim = next_elim, None
            if known is not None and _elim_rejected(known, cur_n, cfg):
                break                 # the agg step's fetch decided it
            t0 = tick()
            if cfg.elim_sizing == "conservative":
                # fused select+build; ONE batched fetch per elim level. A
                # pass rejected here (only the finest level's can be:
                # later ones are decided above) wastes one build.
                elim, out = yield ("step", "elim", (n_cap, e_cap),
                                   (row_d, col_d, val_d, deg_d, n_d))
                n_elim, nnz_c = yield ("fetch", (out["n_f"], out["co_nnz"]))
                n_elim, nnz_c = int(n_elim), int(nnz_c)
                if _elim_rejected(n_elim, cur_n, cfg):
                    break
            else:
                elim, n_elim_d = yield ("step", "elim_select",
                                        (n_cap, e_cap),
                                        (row_d, col_d, val_d, deg_d, n_d))
                (n_elim,) = yield ("fetch", (n_elim_d,))  # decision fetch
                n_elim = int(n_elim)
                if _elim_rejected(n_elim, cur_n, cfg):
                    break
                f_cap = bucket(n_elim, floor)
                out = yield ("step", "elim_build", (n_cap, e_cap, f_cap),
                             (row_d, col_d, val_d, deg_d, n_d, elim))
                (nnz_c,) = yield ("fetch", (out["co_nnz"],))  # sizing fetch
                nnz_c = int(nnz_c)
            specs.append(("elim", dict(n=cur_n, n_f=n_elim,
                                       n_c=cur_n - n_elim, nnz_c=nnz_c,
                                       elim=elim, out=out)))
            yield from advance(out["co_row"], out["co_col"], out["co_val"],
                               out["co_deg"], cur_n - n_elim, nnz_c)
            progressed = True
            if profile is not None:
                profile.append(("elim", specs[-1][1]["n"], tick() - t0))

        if cur_n <= cfg.coarsest_size:
            break

        # --- aggregation level -----------------------------------------
        t0 = tick()
        out = yield ("step", "agg", (n_cap, e_cap),
                     (row_d, col_d, val_d, deg_d, n_d))
        # decision fetch: coarse size (ratio check), coarse nnz (sizing),
        # the renumbering invariant and the next elimination count, in ONE
        n_c, nnz_c, ok, n_elim_next = yield (
            "fetch", (out["n_c"], out["co_nnz"], out["ok"],
                      out["n_elim_next"]))
        if not bool(ok):
            raise RuntimeError("aggregate pointers must hit roots")
        n_c, nnz_c = int(n_c), int(nnz_c)
        if n_c >= cur_n * cfg.min_coarsen_ratio:
            if not progressed:
                break                 # stuck: neither mechanism coarsens
            continue
        specs.append(("agg", dict(n=cur_n, n_c=n_c, nnz_c=nnz_c, out=out)))
        yield from advance(out["co_row"], out["co_col"], out["co_val"],
                           out["co_deg"], n_c, nnz_c)
        next_elim = int(n_elim_next)
        if profile is not None:
            profile.append(("agg", specs[-1][1]["n"], tick() - t0))

    # --- exact-shape wrap + dense bottom solve --------------------------
    level = graph_from_adjacency(adj)
    transfers = []
    lam_maxes = []
    for kind, spec in specs:
        if kind == "elim":
            t = _wrap_elim(level, spec)
            lam_maxes.append(torch.zeros((), device=dev))
        else:
            t = _wrap_agg(level, spec)
            lam_maxes.append(faults.site("setup.lambda_max",
                                         spec["out"]["lam"]))
        transfers.append(t)
        level = t.coarse

    # ONE fetch: the alpha scalar and the coarse index arrays the
    # component analysis needs; what follows is host work
    alpha, row_h, col_h = yield ("fetch", (level.deg.mean(), level.adj.row,
                                           level.adj.col))
    with _host_work(dev):
        coarse_inv = coarse_inverse(level, float(alpha) or 1.0,
                                    row_h.numpy(), col_h.numpy())
        transfers = attach_ell_transfers(transfers, cfg)
    return Hierarchy(transfers=transfers, lam_maxes=tuple(lam_maxes),
                     coarse_inv=coarse_inv)


def _exec_request(steps: SuperstepBuilders, req):
    """Execute one plan request for a single graph."""
    if req[0] == "fetch":
        return _fetch(*req[1])
    _, method, params, args = req
    return steps.step(method, params)(*args)


def build_hierarchy_superstep(adj: COO, cfg, profile: list | None = None,
                              steps: SuperstepBuilders | None = None):
    """Bucket-padded setup on ``adj``'s device. Same contract, and the same
    hierarchy, as ``core.hierarchy.build_hierarchy_eager``.

    ``profile``: optional list; when given, each constructed level appends
    ``(kind, n_fine, seconds)``. Timing waits on the device once per
    level, so leave it ``None`` outside measurements.

    ``steps``: the step factory; defaults to :class:`SuperstepBuilders`
    on ``adj``'s device.
    """
    _validate_setup_cfg(cfg)
    if steps is None:
        steps = SuperstepBuilders(cfg, adj.device)
    plan = _setup_plan(adj, cfg, profile)
    payload = None
    while True:
        try:
            req = plan.send(payload)
        except StopIteration as stop:
            return stop.value
        payload = _exec_request(steps, req)


def build_hierarchy_superstep_batch(adjs, cfg,
                                    steps: SuperstepBuilders | None = None
                                    ) -> list:
    """Drive N setup plans (graphs on one device) in lockstep rounds.

    Each round, requests for the same ``(step, bucket key)`` address run
    through ONE registry entry, and every plan waiting on host scalars
    joins ONE batched fetch. Per-graph decisions stay ordinary host
    control flow inside each plan, so every returned hierarchy is
    **bit-identical** to its single-graph ``build_hierarchy_superstep``
    build. Graphs whose decisions diverge leave the shared group for the
    rounds concerned; a ``setup_bucket_floor`` keeps same-family batches
    grouped end to end.
    """
    adjs = list(adjs)
    _validate_setup_cfg(cfg)
    if not adjs:
        return []
    if steps is None:
        steps = SuperstepBuilders(cfg, adjs[0].device)
    plans = [_setup_plan(adj, cfg) for adj in adjs]
    out: list = [None] * len(plans)
    payload: list = [None] * len(plans)
    live = list(range(len(plans)))
    while live:
        reqs = {}
        nxt = []
        for i in live:
            try:
                reqs[i] = plans[i].send(payload[i])
                payload[i] = None
                nxt.append(i)
            except StopIteration as stop:
                out[i] = stop.value
        live = nxt

        # every plan waiting on host scalars shares ONE batched fetch
        fetchers = [i for i in live if reqs[i][0] == "fetch"]
        if fetchers:
            vals = _fetch(*(v for i in fetchers for v in reqs[i][1]))
            pos = 0
            for i in fetchers:
                k = len(reqs[i][1])
                payload[i] = tuple(vals[pos:pos + k])
                pos += k

        # same-(method, params) step requests run through one entry
        groups: dict = {}
        for i in live:
            if reqs[i][0] == "step":
                _, method, params, _args = reqs[i]
                groups.setdefault((method, params), []).append(i)
        for (method, params), members in groups.items():
            if len(members) == 1:
                i = members[0]
                payload[i] = steps.step(method, params)(*reqs[i][3])
                continue
            outs = steps.step(method, params, batch=len(members))(
                [reqs[i][3] for i in members])
            for i, res in zip(members, outs):
                payload[i] = res
    return out
