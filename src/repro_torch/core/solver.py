"""Public solver API (torch port of ``repro.core.solver``).

    solver = LaplacianSolver.setup(n, rows, cols, vals)   # multigrid setup
    x, info = solver.solve(b, tol=1e-8)                   # PCG + V-cycle
    X, binfo = solver.solve_block(B)                      # B: (n, k)
    step = solver.build_solve_step(n_iters=30)            # no host reads
    solvers = LaplacianSolver.setup_batch([(n, rows, cols, vals), ...])

Runs on the CUDA card unless ``device`` names another device; without a
card and without ``device="cpu"`` it raises. ``random_ordering=True``
applies the paper's §2.2 relabeling (solutions are permuted back).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.cycles import CycleConfig
from repro_torch.core.hierarchy import (Hierarchy, SetupConfig, apply_cycle,
                                        build_hierarchy,
                                        build_hierarchy_batch,
                                        hierarchy_stats)
from repro_torch.core.krylov import (BlockSolveInfo, pcg, pcg_block,
                                     pcg_scanned)
from repro_torch.core.wda import pcg_iteration_work, wda
from repro_torch.device import resolve_device
from repro_torch.graphs.generators import random_relabel, to_laplacian_coo
from repro_torch.testing import faults


@dataclasses.dataclass
class LaplacianSolveInfo:
    iters: int
    residual_norms: list
    converged: bool
    wda: float
    work_per_iteration: float
    status: str = "max_iters"


def _prepare(n, rows, cols, vals, seed, random_ordering, capacity, dev):
    """The host-side part of a setup: the paper's random relabeling, the
    component labels and the Laplacian's adjacency on ``dev``. Returns the
    solver fields and the adjacency."""
    from repro_torch.core.components import connected_components

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    perm = inv_perm = None
    if random_ordering:
        rows, cols, perm, inv_perm = random_relabel(n, rows, cols, seed)
    comp, n_comp = connected_components(n, rows, cols)
    if n_comp == 1:
        comp = None
    adj = to_laplacian_coo(n, rows, cols, vals, capacity=capacity,
                           device=dev)
    return dict(n=n, perm=perm, inv_perm=inv_perm, comp=comp,
                n_comp=n_comp), adj


@dataclasses.dataclass
class LaplacianSolver:
    hierarchy: Hierarchy
    cycle_config: CycleConfig
    n: int
    device: torch.device
    perm: np.ndarray | None = None          # random ordering (paper §2.2)
    inv_perm: np.ndarray | None = None
    # component labels in internal (relabeled) order, None when connected
    comp: np.ndarray | None = None
    n_comp: int = 1

    @staticmethod
    def setup(n: int, rows, cols, vals,
              setup_config: SetupConfig = SetupConfig(),
              cycle_config: CycleConfig = CycleConfig(),
              random_ordering: bool = True, capacity: int | None = None,
              device=None) -> "LaplacianSolver":
        """Build the hierarchy on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        prep, adj = _prepare(n, rows, cols, vals, setup_config.seed,
                             random_ordering, capacity, dev)
        return LaplacianSolver(hierarchy=build_hierarchy(adj, setup_config),
                               cycle_config=cycle_config, device=dev, **prep)

    @staticmethod
    def setup_batch(problems, setup_config: SetupConfig = SetupConfig(),
                    cycle_config: CycleConfig = CycleConfig(),
                    random_ordering: bool = True,
                    device=None) -> "list[LaplacianSolver]":
        """Batched :meth:`setup` on ``device`` (default: the CUDA card).

        ``problems`` is a sequence of ``(n, rows, cols, vals)`` tuples. The
        hierarchies come from ``build_hierarchy_batch``: graphs whose
        levels land in the same capacity buckets share one registry entry
        a level round, and each solver is bit-identical to a looped
        :meth:`setup` of the same problem."""
        dev = resolve_device(device)
        preps, adjs = [], []
        for n, rows, cols, vals in problems:
            prep, adj = _prepare(n, rows, cols, vals, setup_config.seed,
                                 random_ordering, None, dev)
            preps.append(prep)
            adjs.append(adj)
        hs = build_hierarchy_batch(adjs, setup_config)
        return [LaplacianSolver(hierarchy=h, cycle_config=cycle_config,
                                device=dev, **prep)
                for h, prep in zip(hs, preps)]

    @property
    def projector(self):
        """Per-component nullspace projector, or None on connected graphs
        (pcg then keeps its global-mean projection)."""
        if self.comp is None:
            return None
        proj = self.__dict__.get("_projector")
        if proj is None:
            from repro_torch.core.components import component_projector

            proj = component_projector(self.comp, self.n_comp, self.device)
            self.__dict__["_projector"] = proj
        return proj

    def _perm_tensor(self, p: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(p, dtype=torch.int64, device=self.device)

    def _to_internal(self, b: torch.Tensor) -> torch.Tensor:
        return b[self._perm_tensor(self.inv_perm)] \
            if self.perm is not None else b

    def _from_internal(self, x: torch.Tensor) -> torch.Tensor:
        return x[self._perm_tensor(self.perm)] if self.perm is not None else x

    @property
    def _fine(self):
        return self.hierarchy.transfers[0].fine

    # matvec, precondition, projector and the permutations take internal-
    # order vectors or [n, k] blocks (one operation for all k columns)
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._fine.laplacian_matvec(x)

    def precondition(self, r: torch.Tensor) -> torch.Tensor:
        return apply_cycle(self.hierarchy, r, self.cycle_config)

    def _solve_matvec(self):
        """The fine-level matvec the PCG loop drives, past the
        ``sdc.edge_weights`` fault site.

        The site models persistent operator corruption: the stored edge
        weights go bad while the degree vector stays clean, so PCG
        converges, consistently and finitely, to the wrong system's
        solution. The corrupted level drops its ELL twin (COO execution)
        and is rebuilt for each solve; with no plan armed this returns
        ``self.matvec`` untouched.
        """
        fine = self._fine
        val = faults.site("sdc.edge_weights", fine.adj.val)
        if val is fine.adj.val:
            return self.matvec
        adj = dataclasses.replace(fine.adj, val=val)
        bad = dataclasses.replace(fine, adj=adj, ell=None, ell_rem=None)
        return bad.laplacian_matvec

    def solve(self, b, tol: float = 1e-8, maxiter: int = 200,
              precondition: bool = True, guard=True, check=None):
        """PCG preconditioned by the cycle. ``b`` (numpy or tensor, in the
        caller's vertex order) should be mean-free per component.
        ``check`` is an optional ABFT checksum on internal-order vectors
        (``repro_torch.core.verify.make_check``). Returns
        ``(x, LaplacianSolveInfo)`` with ``x`` a float32 tensor on the
        solver's device."""
        b = torch.as_tensor(b, dtype=torch.float32, device=self.device)
        M = self.precondition if precondition else None
        x, info = pcg(self._solve_matvec(), self._to_internal(b), precond=M,
                      tol=tol, maxiter=maxiter, project=self.projector,
                      guard=guard, check=check)
        w = self.iteration_work(precondition)
        out = LaplacianSolveInfo(
            iters=info.iters, residual_norms=info.residual_norms,
            converged=info.converged, work_per_iteration=w,
            wda=wda(info.residual_norms, w), status=info.status)
        return self._from_internal(x), out

    def solve_block(self, B, tol: float = 1e-8, maxiter: int = 200,
                    precondition: bool = True, exact_columns: bool = True,
                    x0=None, guard=True,
                    check=None) -> tuple[torch.Tensor, BlockSolveInfo]:
        """Blocked multi-RHS solve: ``B`` is (n, k), one hierarchy, k solves.

        With ``exact_columns=True`` each column is bitwise equal to a
        single-RHS :meth:`solve` of that column (see ``pcg_block``); with
        ``False`` the matvec and the V-cycle run once an application on the
        whole block (the k-column kernels), the reference's throughput
        path.
        ``x0`` is an optional (n, k) block of initial guesses; ``None``
        starts from zeros. Returns ``(X, BlockSolveInfo)`` with ``X`` a
        float32 (n, k) tensor on the solver's device.
        """
        B_int = self._to_internal(torch.as_tensor(B, dtype=torch.float32,
                                                  device=self.device))
        x0_int = None if x0 is None else self._to_internal(
            torch.as_tensor(x0, dtype=torch.float32, device=self.device))
        M = self.precondition if precondition else None
        X, info = pcg_block(self._solve_matvec(), B_int, precond=M, tol=tol,
                            maxiter=maxiter, exact_columns=exact_columns,
                            x0=x0_int, project=self.projector, guard=guard,
                            check=check)
        return self._from_internal(X), info

    def iteration_work(self, precondition: bool = True) -> float:
        """Work of one PCG iteration in finest-matvec equivalents (WDA)."""
        if not precondition:
            return 1.0
        return pcg_iteration_work(self.hierarchy, self.cycle_config)

    def build_solve_step(self, n_iters: int = 30):
        """A fixed-shape function ``b -> (x, residual_norms)`` on
        internal-order vectors: ``n_iters`` unguarded PCG iterations
        (``pcg_scanned``) that read nothing back to the host."""
        return functools.partial(pcg_scanned, self.matvec,
                                 precond=self.precondition, n_iters=n_iters,
                                 project=self.projector)

    def stats(self) -> dict:
        return hierarchy_stats(self.hierarchy)
