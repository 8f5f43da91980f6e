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
``options.device`` (default: the CUDA card). ``dist`` (ROADMAP A11) is
registered so that the registry lists the reference's names, and raises
``NotImplementedError`` at setup.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.registry import register_backend


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


def _not_ported(name: str, item: str):
    def setup_fn(problem, options, mesh=None):
        raise NotImplementedError(
            f"the {name!r} backend is not ported yet (ROADMAP {item}); use "
            f"backend='single'")

    return setup_fn


register_backend("single", _setup_single)
register_backend("serial_ref", _setup_serial_ref)
register_backend("dist", _not_ported("dist", "A11"))
