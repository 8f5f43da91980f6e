"""Distributed SOLVE phase: PCG + V-cycle with the 2D-distributed SpMV
(paper §3; torch port of ``repro.dist.solver``).

``DistLaplacianSolver`` builds the same multigrid hierarchy as
``core.solver.LaplacianSolver`` (by default through the distributed
super-step, ``repro_torch.dist.setup``), then splits it at
``dist_nnz_threshold`` / ``max_dist_levels``:

* the top (largest) levels get their adjacency cut into the paper's 2D
  block layout (``repro_torch.dist.partition``); every rank keeps its own
  block and contracts it against the replicated vector, and one
  ``all_reduce`` over the mesh plays the paper's column-reduce + row
  broadcast;
* levels below the threshold stay in the replicated serial tail
  (``coarse_h``), whose ELL twins run the ``spmv_ell`` and ``jacobi``
  kernels: coarse grids are too small to be worth distributing.

With ``matvec_backend != "coo"`` a distributed level's block is a hybrid
ELL+COO split (global column ids, sentinel ``n_pad``) that runs the
``spmv_ell`` kernel on the rank's ``[nb, width]`` table against the
replicated ``x`` of length ``n_pad``; the COO path is a segment sum over
the block's edges. The transfer operators are the serial ones, so the
distributed solver is the serial solver with its big SpMVs distributed.

The blocked PCG is the reference's scanned solve written as eager loops:
the same active mask and freezing, guard lanes and ``check`` lane, run in
chunks of ``_CHUNK`` steps with an exit at the first chunk boundary where
every column is done. The matvec of a block is one all-reduce for all its
columns; the preconditioner runs a column at a time (a multi-column ELL
SpMV is ROADMAP B1). Every decision the host makes (the split, the chunk
exit) reads values that went through an all-reduce or were computed
identically on every rank, so the ranks stay in step.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cycles import CycleConfig, cycle
from repro_torch.core.elimination import EliminationLevel
from repro_torch.core.graph import graph_from_adjacency
from repro_torch.core.hierarchy import (Hierarchy, SetupConfig,
                                        attach_ell_transfers,
                                        build_hierarchy)
from repro_torch.core.krylov import (SCAN_INDEFINITE, SCAN_NONFINITE,
                                     SCAN_OK, SCAN_SDC, SCAN_STAGNATION,
                                     GuardConfig, _as_guard)
from repro_torch.dist.mesh import ProcessMesh
from repro_torch.dist.partition import (block_row_counts, ell_width_for,
                                        partition_edges_2d, rank_block,
                                        rank_ell_block)
from repro_torch.graphs.generators import random_relabel, to_laplacian_coo
from repro_torch.sparse.segment import segment_sum_plan, take_fill
from repro_torch.testing import faults


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous tensor starting on a 16-byte boundary (the
    ELL kernels' bulk copies need it): a copy only where ``x`` is not."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


@dataclasses.dataclass(frozen=True, eq=False)
class DistGraphLevel:
    """A multigrid level whose adjacency is 2D-partitioned over a mesh;
    this rank holds its own block.

    Drop-in for ``core.graph.GraphLevel`` wherever only ``n``, ``deg`` and
    ``laplacian_matvec`` are used (smoothers, residuals, PCG): the matvec
    is the distributed SpMV. COO execution holds the block's edges
    (``row``/``col``/``val``, global ids, sentinel ``n_pad``) and their
    segment-sum plan; ELL execution holds the block's ``[nb, width]``
    table (``ell_col``/``ell_val``) and its spill (None when the block
    spills nothing), contracted by the ``spmv_ell`` kernel. Either way the
    rank's partial is summed by one all-reduce.
    """

    deg: torch.Tensor          # float32 [n] weighted degrees (replicated)
    n: int
    n_pad: int
    nb: int
    nb_col: int
    capacity: int              # the partition's common block capacity
    mesh: ProcessMesh
    row: torch.Tensor | None = None      # int32 [capacity], COO execution
    col: torch.Tensor | None = None
    val: torch.Tensor | None = None
    ell_col: torch.Tensor | None = None  # int32 [nb, width], ELL execution
    ell_val: torch.Tensor | None = None
    spill_row: torch.Tensor | None = None
    spill_col: torch.Tensor | None = None
    spill_val: torch.Tensor | None = None

    def __post_init__(self):
        # constants of the level, made once: the padded degrees and the
        # segment-sum plans of the fixed ids (one sort, not one per SpMV)
        pad = self.n_pad - self.n
        set_ = object.__setattr__
        set_(self, "deg_pad", torch.nn.functional.pad(self.deg, (0, pad)))
        set_(self, "row0", self.mesh.block[1] * self.nb)
        set_(self, "_plan", None if self.row is None
             else segment_sum_plan(self.row, self.n_pad))
        set_(self, "_spill_plan", None if self.spill_row is None
             else segment_sum_plan(self.spill_row, self.n_pad))

    def _site_shard(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return faults.site_traced(name, x, axis_index=self.mesh.shard_index,
                                  n_shards=self.mesh.size)

    def _partial_coo(self, X: torch.Tensor) -> torch.Tensor:
        # one seeded shard's local value payload can be silently corrupted
        val = self._site_shard("sdc.shard_payload", self.val)
        valid = self.row < self.n_pad
        if X.dim() == 2:
            val, valid = val[:, None], valid[:, None]
        prod = torch.where(valid, val * take_fill(X, self.col, 0), 0)
        return self._plan(prod)

    def _partial_ell(self, X: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.spmv_ell import spmv_ell

        # the same one-bad-shard payload model, on the values the kernel
        # contracts
        ev = self._site_shard("sdc.shard_payload", self.ell_val)
        cols = [X] if X.dim() == 1 else [X[:, j] for j in range(X.shape[1])]
        ys = [spmv_ell(self.ell_col, ev, _aligned(x)) for x in cols]
        y = ys[0] if X.dim() == 1 else torch.stack(ys, dim=1)
        if self.nb == self.n_pad:
            part = y
        else:
            part = X.new_zeros(X.shape)
            part[self.row0:self.row0 + self.nb] = y
        if self.spill_row is not None:
            sv = self.spill_val if X.dim() == 1 else self.spill_val[:, None]
            part = part + self._spill_plan(sv * take_fill(X, self.spill_col,
                                                          0))
        return part

    def spmv_padded(self, x_pad: torch.Tensor) -> torch.Tensor:
        """y = A @ x on [n_pad] vectors, or [n_pad, k] blocks (one
        all-reduce for all k columns)."""
        part = (self._partial_coo(x_pad) if self.ell_col is None
                else self._partial_ell(x_pad))
        # one seeded shard's all-reduce contribution can be corrupted
        part = self._site_shard("dist.psum", part)
        # the column-communicator reduce + row broadcast: one all-reduce
        return self.mesh.psum(part.contiguous())

    def laplacian_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """L @ x on length-n vectors (the smoother / residual interface)."""
        x_pad = torch.nn.functional.pad(x, (0, self.n_pad - self.n))
        return self.deg * x - self.spmv_padded(x_pad)[: self.n]

    def matvec_padded(self, x_pad: torch.Tensor) -> torch.Tensor:
        """L @ x on [n_pad] vectors or [n_pad, k] blocks (the PCG
        iteration space)."""
        deg = self.deg_pad if x_pad.dim() == 1 else self.deg_pad[:, None]
        return deg * x_pad - self.spmv_padded(x_pad)


@dataclasses.dataclass(frozen=True)
class DistArrays:
    """Distributed state: ``fine`` is the finest level (a
    ``DistGraphLevel`` when any level is distributed, the serial
    ``GraphLevel`` otherwise); ``transfers`` are the distributed-prefix
    transfer operators with their fine levels swapped for
    ``DistGraphLevel`` twins."""

    fine: object
    transfers: tuple
    lam_maxes: tuple


@dataclasses.dataclass(frozen=True)
class DistLevelMeta:
    """Host-side description of one distributed level."""

    kind: str             # "elim" | "agg"
    n: int
    nnz: int
    n_pad: int
    capacity: int
    fill_fraction: float
    ell_width: int | None = None   # hybrid block width (None = COO execution)
    ell_spill: int | None = None   # total spill edges across blocks


# ----------------------------------------------------------------------------
# The blocked PCG, as eager loops over [n_pad, k] blocks
# ----------------------------------------------------------------------------

def _block_ops(matvec, precond, n: int, n_pad: int, device):
    """Block operators + masked projection for [n_pad, k] blocks.

    ``matvec`` takes a whole block (one all-reduce); ``precond`` takes
    one column and is lifted over every column, as the reference's vmap
    is (a frozen column's result is selected away, and knowing which
    columns are frozen would take a host read). The mean-free projection
    (the Laplacian nullspace) averages over the n real entries and pins
    padding to zero."""
    mask = (torch.arange(n_pad, device=device) < n)[:, None]

    def bM(V):
        return torch.stack([precond(V[:, j].contiguous())
                            for j in range(V.shape[1])], dim=1)

    def proj(V):
        V = torch.where(mask, V, 0)
        return torch.where(mask, V - torch.sum(V, dim=0)[None, :] / n, 0)

    def cnorm(V):
        return torch.linalg.vector_norm(V, dim=0)

    return matvec, bM, proj, cnorm


def _pcg_block_init(ops, B, guard=None):
    """Blocked PCG carry for B [n_pad, k]: ``(X, R, Z, P, rz, iters,
    r0n)`` unguarded; with a ``GuardConfig`` three status lanes ride it
    (per-column int32 ``SCAN_*`` codes, the best residual norm, a stall
    counter): ``(X, R, Z, P, rz, iters, code, best, stall, r0n)``. A
    column whose initial residual norm is non-finite starts frozen with
    ``SCAN_NONFINITE``."""
    bmv, bM, proj, cnorm = ops
    k = B.shape[1]
    B = proj(B)
    X0 = torch.zeros_like(B)
    R0 = proj(B - bmv(X0))
    Z0 = proj(bM(R0))
    r0n = cnorm(R0)
    iters = torch.zeros(k, dtype=torch.int32, device=B.device)
    base = (X0, R0, Z0, Z0, torch.sum(R0 * Z0, dim=0), iters)
    if guard is None:
        return base + (r0n,)
    fin = torch.isfinite(r0n)
    code0 = torch.where(fin, SCAN_OK, SCAN_NONFINITE).to(torch.int32)
    best0 = torch.where(fin, r0n, torch.inf)
    return base + (code0, best0, torch.zeros_like(iters), r0n)


# The two halves of a step that the unguarded and guarded programs share,
# op for op (the guards-on/off bitwise contract): converged and frozen
# columns meet zero steps and keep their residual exactly (re-projecting
# it would drift the reported norms).

def _step_update(ops, active, X, R, P, alpha, Ap):
    proj = ops[2]
    X = X + alpha[None, :] * P
    R = torch.where(active[None, :], proj(R - alpha[None, :] * Ap), R)
    return X, R


def _step_direction(ops, active, R, Z, P, rz):
    _, bM, proj, _ = ops
    Z = torch.where(active[None, :], proj(bM(R)), Z)
    rz_new = torch.sum(R * Z, dim=0)
    beta = torch.where(active, rz_new / torch.clamp(rz, min=1e-30), 0.0)
    return Z, Z + beta[None, :] * P, rz_new


def _pcg_block_chunk(ops, tol: float, length: int, carry, guard=None,
                     check=None, build=None):
    """Advance a blocked PCG carry ``length`` steps.

    Each step carries a residual-based active mask: once a column's
    residual norm drops below ``tol * ||r0||`` its alpha is zeroed and its
    residual pinned. With ``guard`` (carry from the guarded init) the
    breakdown guards freeze a column per step: an indefinite or non-finite
    ``p·Ap`` BEFORE the poisoned update, a non-finite residual norm after
    it, and ``stagnation_window`` active steps without relative
    improvement. ``check(P, Ap) -> bool[k]`` (guarded only) freezes a
    flagged column with ``SCAN_SDC`` first. The iteration SpMV passes the
    ``dist.spmv`` site. On a clean trajectory every guard predicate is
    false and X, norms and iters are bitwise the unguarded ones. Each step
    is one pass of ``build`` (the program's traced sites).

    Returns ``(carry, norms [length, k])``; ``carry[5]`` counts the steps
    each column was active, cumulative across chunks.
    """
    bmv, _, _, cnorm = ops
    build = build or faults.TracedBuild()
    norms = []
    if guard is None:
        X, R, Z, P, rz, iters, r0n = carry
        for _ in range(length):
            with build.run():
                active = cnorm(R) > tol * r0n
                iters = iters + active.to(torch.int32)
                Ap = bmv(P)
                pAp = torch.sum(P * Ap, dim=0)
                alpha = torch.where(active, rz / torch.clamp(pAp, min=1e-30),
                                    0.0)
                X, R = _step_update(ops, active, X, R, P, alpha, Ap)
                Z, P, rz = _step_direction(ops, active, R, Z, P, rz)
                norms.append(cnorm(R))
        return (X, R, Z, P, rz, iters, r0n), torch.stack(norms)

    g = guard
    X, R, Z, P, rz, iters, code, best, stall, r0n = carry
    for _ in range(length):
        with build.run():
            active = (cnorm(R) > tol * r0n) & (code == SCAN_OK)
            Ap = faults.site_traced("dist.spmv", bmv(P))
            if check is not None:
                sdc = active & check(P, Ap)
                code = torch.where(sdc, SCAN_SDC, code)
                active = active & ~sdc
            pAp = torch.sum(P * Ap, dim=0)
            indef = active & ~(torch.isfinite(pAp) & (pAp > 0.0))
            code = torch.where(indef, SCAN_INDEFINITE, code)
            active = active & ~indef
            iters = iters + active.to(torch.int32)
            alpha = torch.where(active, rz / torch.clamp(pAp, min=1e-30),
                                0.0)
            X, R = _step_update(ops, active, X, R, P, alpha, Ap)
            rn = cnorm(R)
            nonf = active & ~torch.isfinite(rn)
            code = torch.where(nonf, SCAN_NONFINITE, code)
            active = active & ~nonf
            improved = active & (rn < best * (1.0 - g.stagnation_rtol))
            best = torch.where(improved, rn, best)
            stall = torch.where(improved, 0, stall + active.to(torch.int32))
            stalled = active & (stall >= g.stagnation_window)
            code = torch.where(stalled, SCAN_STAGNATION, code)
            active = active & ~stalled
            # frozen columns meet zeroed betas, and a broken column's NaN
            # rz never reaches X (its alpha selects 0)
            Z, P, rz = _step_direction(ops, active, R, Z, P, rz)
            norms.append(rn)
    return (X, R, Z, P, rz, iters, code, best, stall, r0n), \
        torch.stack(norms)


class _Program:
    """One build of a solve program: its traced fault sites draw once and
    replay on every later call (``repro_torch.testing.faults``)."""

    def __init__(self, fn):
        self.fn = fn
        self.build = faults.TracedBuild()

    def __call__(self, *args):
        return self.fn(*args, build=self.build)


# ----------------------------------------------------------------------------
# Partitioning a level
# ----------------------------------------------------------------------------

def _partition_level(level, mesh: ProcessMesh, matvec_backend: str = "coo",
                     ell_width_percentile: float = 95.0,
                     ell_width_cap: int = 64):
    """2D-partition one level's adjacency and keep this rank's block on
    the mesh's device, as COO or (``matvec_backend != "coo"``, unless
    ``"auto"`` refuses the level) as a hybrid ELL+COO split. Returns
    ``(DistGraphLevel, fill_fraction, ell_width or None, ell_spill or
    None)``."""
    from repro_torch.sparse.matvec import validate_backend

    validate_backend(matvec_backend)
    adj = level.adj
    row, col, val = (t.cpu().numpy() for t in (adj.row, adj.col, adj.val))
    # A corrupted upstream setup (fault injection, overflowed aggregate
    # ids) can leave vertex ids outside [0, n): such edges are dropped here
    # so the damage surfaces as a breakdown status at solve time. Clean
    # levels always have in-range ids.
    n = level.n
    valid = (row >= 0) & (row < n) & (col >= 0) & (col < n)
    part = partition_edges_2d(n, row[valid], col[valid], val[valid],
                              mesh.pr, mesh.pc, pods=mesh.pods,
                              random_ordering=False)
    dev = mesh.device
    kw: dict = {}
    width = spill = None
    if matvec_backend != "coo":
        counts = block_row_counts(part)
        width = ell_width_for(part, counts,
                              percentile=ell_width_percentile,
                              cap=ell_width_cap, backend=matvec_backend)
    if width is None:
        blk = rank_block(part, mesh.block, dev)
        kw = dict(row=blk["row"], col=blk["col"], val=blk["val"])
    else:
        blk = rank_ell_block(part, mesh.block, width, dev)
        kw = dict(ell_col=blk["col"], ell_val=blk["val"],
                  spill_row=blk["spill_row"], spill_col=blk["spill_col"],
                  spill_val=blk["spill_val"])
        spill = int(np.maximum(counts - width, 0).sum())
    dlevel = DistGraphLevel(deg=level.deg, n=n, n_pad=part.n_pad,
                            nb=part.nb, nb_col=part.nb_col,
                            capacity=part.capacity, mesh=mesh, **kw)
    return dlevel, part.fill_fraction, width, spill


# ----------------------------------------------------------------------------
# The solver
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class DistLaplacianSolver:
    """2D-distributed PCG + V-cycle solver (the paper's solve phase).

    * ``setup(n, rows, cols, vals, mesh, setup_config, ...)``
    * ``solve(b, n_iters, tol)`` -> ``(x, residual_norms)``
    * ``solve_block(B, n_iters, tol)`` -> ``(X, norms, iters)`` multi-RHS
    * ``build_init_step``/``build_chunk_step``: the init and chunk
      programs ``solve_block`` runs, which read nothing back to the host
    * ``level_meta`` (per distributed level), ``coarse_h`` (the replicated
      tail ``Hierarchy``), ``arrays``, ``n_pad``, ``work_per_iteration``
      (WDA accounting, from the pre-split hierarchy).

    Every rank of ``mesh`` calls the same methods with the same
    arguments; ``X`` comes back replicated on every rank, on
    ``mesh.device``.
    """

    arrays: DistArrays
    coarse_h: Hierarchy
    level_meta: list
    cycle_config: CycleConfig
    n: int
    n_pad: int
    mesh: ProcessMesh
    perm: np.ndarray | None = None         # §2.2 random ordering
    inv_perm: np.ndarray | None = None
    work_per_iteration: float = 0.0        # PCG iter cost in finest matvecs
    # solve programs keyed by their shape and options, so repeat solves
    # reuse them (and, under an armed fault plan, never do)
    _steps: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    # ------------------------------------------------------------------
    @staticmethod
    def setup(n: int, rows, cols, vals, mesh: ProcessMesh,
              setup_config: SetupConfig = SetupConfig(),
              cycle_config: CycleConfig = CycleConfig(),
              dist_nnz_threshold: int = 10_000,
              max_dist_levels: int = 3,
              random_ordering: bool = True,
              profile: list | None = None) -> "DistLaplacianSolver":
        """Build the hierarchy on ``mesh.device`` and distribute its top
        levels. ``profile``: optional list; gets ``("setup", seconds)``
        for the hierarchy, then ``("partition", level, seconds)`` for each
        distributed level's host partition."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, np.float32)
        perm = inv_perm = None
        if random_ordering:
            rows, cols, perm, inv_perm = random_relabel(
                n, rows, cols, setup_config.seed)
        dev = mesh.device
        t0 = time.perf_counter()
        adj = to_laplacian_coo(n, rows, cols, vals, device=dev)
        # The hierarchy is built without replicated ELL twins: the largest
        # levels get per-block layouts below, and the replicated tail gets
        # its twins after the split. setup_mode="superstep" (the default)
        # runs the distributed super-step (Alg 1 and the Alg 2 rounds as
        # collectives over the mesh); "eager" the host-driven loop. Both
        # give the same hierarchy.
        setup_cfg = dataclasses.replace(setup_config, matvec_backend="coo")
        if setup_config.setup_mode == "superstep":
            from repro_torch.dist.setup import build_hierarchy_superstep_dist

            h = build_hierarchy_superstep_dist(adj, setup_cfg, mesh)
        else:
            h = build_hierarchy(adj, setup_cfg)
        if profile is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            profile.append(("setup", time.perf_counter() - t0))

        # one batched fetch for every candidate level's nnz (the split)
        nnzs = torch.stack([t.fine.adj.valid.sum() for t in h.transfers]
                           ).tolist() if h.transfers else []
        dist_transfers, lam_maxes, level_meta = [], [], []
        for t, lam, nnz in zip(h.transfers, h.lam_maxes, nnzs):
            if len(dist_transfers) >= max_dist_levels \
                    or nnz < dist_nnz_threshold:
                break
            t0 = time.perf_counter()
            dfine, fill, width, spill = _partition_level(
                t.fine, mesh, matvec_backend=setup_config.matvec_backend,
                ell_width_percentile=setup_config.ell_width_percentile,
                ell_width_cap=setup_config.ell_width_cap)
            if profile is not None:
                profile.append(("partition", len(dist_transfers),
                                time.perf_counter() - t0))
            dist_transfers.append(dataclasses.replace(t, fine=dfine))
            lam_maxes.append(lam)
            level_meta.append(DistLevelMeta(
                kind="elim" if isinstance(t, EliminationLevel) else "agg",
                n=t.fine.n, nnz=nnz, n_pad=dfine.n_pad,
                capacity=dfine.capacity, fill_fraction=fill,
                ell_width=width, ell_spill=spill))

        k = len(dist_transfers)
        coarse_transfers = attach_ell_transfers(h.transfers[k:],
                                                setup_config)
        coarse_h = Hierarchy(transfers=coarse_transfers,
                             lam_maxes=h.lam_maxes[k:],
                             coarse_inv=h.coarse_inv)
        if k:
            fine, n_pad = dist_transfers[0].fine, dist_transfers[0].fine.n_pad
        elif coarse_transfers:
            fine, n_pad = coarse_transfers[0].fine, n   # full serial fallback
        else:
            fine, n_pad = graph_from_adjacency(adj), n

        from repro_torch.core.wda import pcg_iteration_work

        arrays = DistArrays(fine=fine, transfers=tuple(dist_transfers),
                            lam_maxes=tuple(lam_maxes))
        return DistLaplacianSolver(
            arrays=arrays, coarse_h=coarse_h, level_meta=level_meta,
            cycle_config=cycle_config, n=n, n_pad=n_pad, mesh=mesh,
            perm=perm, inv_perm=inv_perm,
            work_per_iteration=pcg_iteration_work(h, cycle_config))

    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _operators(self, arrays, coarse_h):
        """Block operators on [n_pad, k] for the current split."""
        n, n_pad = self.n, self.n_pad
        cyc = self.cycle_config
        fine = arrays.fine
        if isinstance(fine, DistGraphLevel):
            matvec = fine.matvec_padded
        else:                                   # n_pad == n fallback
            def matvec(V):
                return torch.stack([fine.laplacian_matvec(
                    V[:, j].contiguous()) for j in range(V.shape[1])], 1)
        transfers = arrays.transfers + coarse_h.transfers
        lams = arrays.lam_maxes + coarse_h.lam_maxes

        def precond(r_pad):
            z = cycle(transfers, lams, coarse_h.coarse_inv, r_pad[:n], cyc)
            return torch.nn.functional.pad(z, (0, n_pad - n))

        return _block_ops(matvec, precond, n, n_pad, self.device)

    def build_init_step(self, guard=None):
        """``(arrays, coarse_h, B_pad [n_pad, k]) -> carry``."""
        def step(arrays, coarse_h, B_pad, build=None):
            build = build or faults.TracedBuild()
            with build.run():
                return _pcg_block_init(self._operators(arrays, coarse_h),
                                       B_pad, guard=guard)

        return step

    def build_chunk_step(self, length: int, tol: float = 0.0, guard=None,
                         check=None):
        """``(arrays, coarse_h, carry) -> (carry, norms [length, k])``."""
        def step(arrays, coarse_h, carry, build=None):
            return _pcg_block_chunk(self._operators(arrays, coarse_h), tol,
                                    length, carry, guard=guard, check=check,
                                    build=build)

        return step

    # ------------------------------------------------------------------
    def _perm_t(self, name: str) -> torch.Tensor:
        """``perm``/``inv_perm`` on the device, copied there once."""
        key = "_device_" + name
        t = self.__dict__.get(key)
        if t is None:
            t = self.__dict__[key] = torch.as_tensor(
                getattr(self, name), dtype=torch.int64, device=self.device)
        return t

    def _to_internal(self, b: torch.Tensor) -> torch.Tensor:
        return b[self._perm_t("inv_perm")] if self.perm is not None else b

    def _from_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x[self._perm_t("perm")] if self.perm is not None else x

    def solve(self, b, n_iters: int = 30, tol: float = 1e-8):
        """Distributed PCG solve: at most ``n_iters`` steps, with a
        residual-based exit at ``tol * ||r0||`` (``tol=0``: fixed
        iterations). Returns ``(x [n], norms [T+1])``."""
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        X, norms, _ = self.solve_block(b[:, None], n_iters=n_iters, tol=tol)
        return X[:, 0], norms[:, 0]

    # chunk length of the solve: long enough that host round-trips
    # amortise, short enough that a solve converging in tens of iterations
    # never pays hundreds
    _CHUNK = 16

    def _get_step(self, key, build):
        """The cached program for ``key``; a new one (a new build of its
        traced sites) each call while a traced fault plan is armed."""
        if faults.trace_token() is not None:
            return _Program(build())
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = _Program(build())
        return step

    def solve_block(self, B, n_iters: int = 30, tol: float = 1e-8,
                    guard=None, check=None):
        """Blocked multi-RHS distributed solve: ``B`` is (n, k).

        All k columns advance in lockstep: each step's matvec is one
        all-reduce for the block. With ``tol > 0`` and ``n_iters > 2 *
        _CHUNK`` the steps run in chunks of ``_CHUNK`` and stop at the
        first chunk boundary where every column has converged. Returns
        ``(X [n, k] tensor, norms [T+1, k], iters [k])`` with T <=
        n_iters.

        ``guard`` (bool or ``GuardConfig``) turns on the in-step breakdown
        lanes: the return grows the per-column int32 ``SCAN_*`` codes, and
        broken columns count as done for the chunk exit. ``check`` is an
        ABFT checksum over *padded* ``(P, Ap)`` blocks
        (``core.verify.make_check`` on the padded degrees); it implies a
        default ``GuardConfig``. Clean X/norms/iters are bitwise the same
        with either on or off.
        """
        B = torch.as_tensor(B, dtype=torch.float32, device=self.device)
        if B.dim() != 2:
            raise ValueError(f"solve_block expects B of shape (n, k), "
                             f"got {tuple(B.shape)}")
        k = B.shape[1]
        B_pad = torch.nn.functional.pad(self._to_internal(B),
                                        (0, 0, 0, self.n_pad - self.n))
        tol = float(tol)
        g = _as_guard(guard)
        if check is not None and g is None:
            g = GuardConfig()

        init = self._get_step(("init", k, g),
                              lambda: self.build_init_step(guard=g))
        carry = init(self.arrays, self.coarse_h, B_pad)
        r0n = carry[-1].cpu().numpy()

        # small caps run as one program; chunking only pays once the cap
        # is far beyond typical convergence
        chunked = tol > 0 and n_iters > 2 * self._CHUNK
        norms_parts = [r0n[None, :]]
        it = 0
        while it < n_iters:
            length = min(self._CHUNK, n_iters - it) if chunked else n_iters
            step = self._get_step(
                ("chunk", k, length, tol, g, check),
                lambda: self.build_chunk_step(length, tol=tol, guard=g,
                                              check=check))
            carry, ns = step(self.arrays, self.coarse_h, carry)
            # one host read a chunk: its norms (and the codes)
            fetched = torch.cat([ns.reshape(-1)] + (
                [] if g is None else [carry[6].to(ns.dtype)])).cpu().numpy()
            norms_parts.append(fetched[: ns.numel()].reshape(ns.shape))
            it += length
            if tol > 0:
                done = norms_parts[-1][-1] <= tol * r0n
                if g is not None:
                    done = done | (fetched[ns.numel():] != SCAN_OK)
                if np.all(done):
                    break
        X_pad, iters = carry[0], carry[5]
        norms = np.concatenate(norms_parts, axis=0)
        out = (self._from_internal(X_pad[: self.n]), norms,
               iters.cpu().numpy())
        if g is not None:
            out = out + (carry[6].cpu().numpy(),)
        return out
