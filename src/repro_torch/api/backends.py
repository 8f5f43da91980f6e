"""The built-in backends behind the ``repro_torch.api`` facade (torch port
of ``repro.api.backends``).

Each backend adapts a solver implementation to the handle protocol the
facade consumes:

    handle = setup_fn(problem, options, mesh)
    X, norms, iters, statuses = handle.solve_block(B, tol, max_iters)
    handle.work_per_iteration                                 # WDA units
    handle.stats()                                            # hierarchy dict

``solve_block`` takes and returns 2-D host blocks ``(n, k)``; ``norms`` is
the ``(T+1, k)`` lockstep residual history, ``iters`` the per-column
iteration counts and ``statuses`` the per-column Krylov status codes.
Third-party handles may return the legacy 3-tuple without statuses.

``single`` (the parallel solver) and ``serial_ref`` (the serial
LAMG-style reference, ``repro_torch.core.serial_ref``) run on
``options.device`` (default: the CUDA card). ``dist`` runs the
2D-distributed solver (``repro_torch.dist``) on a process mesh: every rank
of the mesh sets up and solves with the same arguments.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.registry import register_backend


def default_mesh(device=None):
    """A √P×√P-ish ``("data", "model")`` mesh over the default process
    group: its size is factored as pr × pc with pr the largest divisor
    ≤ √P, the paper's 2D processor grid (the reference's rule). Without
    a default group this first starts a world of one on ``device``
    (``repro_torch.dist.init_world``: NCCL on the card, gloo on the
    CPU)."""
    import torch.distributed as dist

    from repro_torch.dist.mesh import factor_grid, init_world, make_mesh

    if not dist.is_initialized():
        return init_world(device)
    return make_mesh(factor_grid(dist.get_world_size()), ("data", "model"),
                     device=device)


class _EagerHandle:
    """Handle over a ``LaplacianSolver``."""

    def __init__(self, solver, options):
        self._solver = solver
        self._options = options
        self.work_per_iteration = solver.iteration_work(
            precondition=options.precondition)
        # the checksum closure is built ONCE from the clean setup-time
        # operator (deg and, paranoid, the witness product u = L w), so a
        # later operator corruption cannot poison what the checks compare
        # against
        vcfg = options.verify_config()
        self._check = None
        if vcfg is not None:
            from repro_torch.core.verify import make_check

            self._check = make_check(solver._fine.deg, vcfg,
                                     matvec=solver.matvec)

    def solve_block(self, B, tol: float, max_iters: int, x0=None,
                    guard=None):
        # ``guard`` overrides the options-derived policy for this call
        # (triage passes a tightened GuardConfig); None keeps the default
        g = self._options.guard_config() if guard is None else guard
        X, info = self._solver.solve_block(
            B, tol=tol, maxiter=max_iters,
            precondition=self._options.precondition,
            exact_columns=self._options.exact_columns, x0=x0,
            guard=g or False, check=self._check)
        return (X.cpu().numpy(), info.residual_norms,
                np.asarray(info.iters, np.int64), info.status)

    def stats(self) -> dict:
        return self._solver.stats()


class _DistHandle:
    """Handle over a ``DistLaplacianSolver`` on a process mesh."""

    def __init__(self, solver, options):
        self._solver = solver
        self._options = options
        self.work_per_iteration = solver.work_per_iteration
        # the checksum closure works in the PADDED iteration space (the
        # blocked PCG's P/Ap are [n_pad, k]); padded rows carry deg 0 and
        # the padded operator is symmetric, so both the column-sum
        # identity and the Rademacher witness hold unchanged
        vcfg = options.verify_config()
        self._check = None
        if vcfg is not None:
            from repro_torch.core.verify import make_check
            from repro_torch.dist.solver import DistGraphLevel

            fine = solver.arrays.fine
            if isinstance(fine, DistGraphLevel):
                deg, mv = fine.deg_pad, fine.matvec_padded
            else:                       # replicated fallback: n_pad == n
                deg, mv = fine.deg, fine.laplacian_matvec
            self._check = make_check(deg, vcfg, matvec=mv)

    def solve_block(self, B, tol: float, max_iters: int, x0=None,
                    guard=None):
        if x0 is not None:
            raise NotImplementedError(
                "the dist backend's blocked solve does not accept "
                "per-column initial guesses; use backend='single' or "
                "'serial_ref' for x0 warm starts")
        g = self._options.guard_config() if guard is None else (guard or None)
        check = self._check
        if check is not None and g is None:
            # the SDC verdict needs the in-step code lane to land in
            from repro_torch.core.krylov import GuardConfig

            g = GuardConfig()
        if g is not None and (self._options.guard_mode == "in_scan"
                              or check is not None):
            # the guards run inside the blocked PCG as status lanes:
            # statuses are live device truth (an indefinite p·Ap freezes
            # the column before the poisoned update, which the norms
            # alone never show); clean paths are bitwise unchanged
            from repro_torch.core.krylov import scan_status_from_codes

            X, norms, iters, codes = self._solver.solve_block(
                B, n_iters=max_iters, tol=tol, guard=g, check=check)
            statuses = scan_status_from_codes(codes, norms, tol, norms[0])
        elif g is not None:
            # guard_mode="postmortem": the unguarded program plus the
            # deprecated host-side reconstruction from the norms
            from repro_torch.core.krylov import scan_norms_status

            X, norms, iters = self._solver.solve_block(B, n_iters=max_iters,
                                                       tol=tol)
            statuses = scan_norms_status(norms, tol, norms[0])
        else:
            # guards off: converged / max_iters / non-finite from the
            # fetched norms is the intended semantics, not a postmortem
            from repro_torch.core.krylov import _norms_status

            X, norms, iters = self._solver.solve_block(B, n_iters=max_iters,
                                                       tol=tol)
            statuses = _norms_status(norms, tol, norms[0])
        return (X.cpu().numpy(), norms, np.asarray(iters, np.int64),
                statuses)

    def stats(self) -> dict:
        from repro_torch.core.hierarchy import hierarchy_stats

        s = self._solver
        levels = [dict(kind=m.kind, n=m.n, nnz=m.nnz,
                       fill_fraction=m.fill_fraction, distributed=True,
                       ell_width=m.ell_width, ell_spill=m.ell_spill)
                  for m in s.level_meta]
        if s.coarse_h.transfers:
            tail = hierarchy_stats(s.coarse_h)
        else:
            # fully distributed hierarchy: the replicated tail is just the
            # dense coarsest solve; its row as hierarchy_stats gives it
            row = dict(kind="coarse", n=int(s.coarse_h.coarse_inv.shape[0]),
                       nnz=None, capacity=None)
            if s.arrays.transfers:
                c = s.arrays.transfers[-1].coarse
                row.update(nnz=c.adj.nnz, capacity=c.adj.capacity)
            tail = dict(levels=[row], n_levels=1)
        for lvl in tail["levels"]:
            lvl["distributed"] = False
        return dict(levels=levels + tail["levels"],
                    n_levels=len(levels) + tail["n_levels"],
                    mesh_shape=s.mesh.axis_sizes())


def _setup_single(problem, options, mesh=None):
    from repro_torch.core.solver import LaplacianSolver

    solver = LaplacianSolver.setup(
        problem.n, problem.rows, problem.cols,
        problem.vals.astype(np.float32),
        setup_config=options.setup_config(),
        cycle_config=options.cycle_config(),
        random_ordering=options.random_ordering, device=options.device)
    return _EagerHandle(solver, options)


def _setup_serial_ref(problem, options, mesh=None):
    from repro_torch.core.serial_ref import serial_lamg_solver

    solver = serial_lamg_solver(
        problem.n, problem.rows, problem.cols,
        problem.vals.astype(np.float32),
        setup_config=options.setup_config(),
        cycle_config=options.cycle_config(),
        random_ordering=options.random_ordering, device=options.device)
    return _EagerHandle(solver, options)


def _setup_dist(problem, options, mesh=None):
    from repro_torch.device import resolve_device
    from repro_torch.dist.solver import DistLaplacianSolver

    if not options.precondition:
        raise ValueError(
            "the dist backend always preconditions with the multigrid "
            "cycle; use backend='single' for the plain-CG ablation")
    if mesh is None:
        mesh = default_mesh(options.device)
    elif options.device is not None \
            and resolve_device(options.device) != mesh.device:
        raise ValueError(f"options.device {options.device!r} is not the "
                         f"mesh's device {mesh.device}")
    solver = DistLaplacianSolver.setup(
        problem.n, problem.rows, problem.cols,
        problem.vals.astype(np.float32), mesh,
        setup_config=options.setup_config(),
        cycle_config=options.cycle_config(),
        dist_nnz_threshold=options.dist_nnz_threshold,
        max_dist_levels=options.max_dist_levels,
        random_ordering=options.random_ordering)
    return _DistHandle(solver, options)


register_backend("single", _setup_single)
register_backend("serial_ref", _setup_serial_ref)
register_backend("dist", _setup_dist)
