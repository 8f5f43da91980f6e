"""``repro_torch.api`` — the public solver surface of the port (torch port
of ``repro.api``).

One Problem -> Solver -> Result pipeline::

    from repro_torch.api import Problem, SolverOptions, solve, setup

    problem = Problem.from_edges(n, rows, cols, vals)
    x, result = solve(problem, b)                        # backend="auto"

    solver = setup(problem, SolverOptions(tol=1e-10), backend="single")
    X, result = solver.solve(B)                          # (n, k) multi-RHS

Backends run on the CUDA card unless ``SolverOptions(device=...)`` names
another device (``device="cpu"`` runs on the host).
"""

from repro_torch.api.cache import HierarchyCache
from repro_torch.api.facade import Solver, default_cache, setup, solve
from repro_torch.api.options import SolverOptions
from repro_torch.api.problem import Problem, ProblemValidationError
from repro_torch.api.registry import (available_backends, get_backend,
                                      register_backend, resolve_backend)
from repro_torch.api.result import SolveResult
from repro_torch.api.triage import TriageReport, triage_problem
from repro_torch.core.verify import Certificate

__all__ = [
    "Certificate",
    "HierarchyCache",
    "Problem",
    "ProblemValidationError",
    "SolveResult",
    "Solver",
    "SolverOptions",
    "TriageReport",
    "available_backends",
    "default_cache",
    "get_backend",
    "register_backend",
    "resolve_backend",
    "setup",
    "solve",
    "triage_problem",
]
