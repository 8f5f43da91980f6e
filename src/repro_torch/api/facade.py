"""The facade: ``setup`` once, ``solve`` many (torch port of
``repro.api.facade``).

    from repro_torch.api import Problem, SolverOptions, setup, solve

    problem = Problem.from_edges(n, rows, cols, vals)
    solver = setup(problem)                      # backend="auto"
    x, result = solver.solve(b)                  # one RHS
    X, result = solver.solve(B)                  # B: (n, k) — blocked PCG
    x, result = solve(problem, b)                # one-shot convenience

Inputs and outputs are host numpy arrays; the backend runs on
``SolverOptions.device`` (default: the CUDA card).

Failure handling: the Krylov layer's breakdown guards surface per-column
status codes, and on a breakdown the facade walks a graceful-degradation
ladder (``SolverOptions.fallback``):

1. invalidate the problem's cache entries and retry once against a
   freshly rebuilt hierarchy (a poisoned cached setup must not keep
   serving),
2. diagonal-preconditioned CG straight off the edge list (no hierarchy
   trusted at all — the paper's own baseline),
3. for ``n <= dense_fallback_max``, a dense nullspace-aware direct solve.

Every rung is recorded in ``SolveResult.diagnostics``; the overall
``SolveResult.status`` is ``"degraded"`` when a rung recovered the solve
and ``"failed"`` when the ladder is exhausted — never an unhandled NaN.
A rung that raises an injected fault or a numerical error
(``RUNG_ERRORS``) is recorded with a note and the ladder goes on; any
other exception (a kernel that fails to build or launch, a bug)
propagates.

Admission triage: with ``SolverOptions(triage=True)``, setup also runs a
cheap host-side conditioning score (``repro_torch.api.triage``) that picks
the *starting* rung before any breakdown. The report is the first
``diagnostics`` entry of every solve (``stage="triage"``) and is exposed
as ``Solver.triage``.

Verification: with ``SolverOptions(verify="cheap"|"paranoid")`` every
result carries an independent host float64 certificate
(``repro_torch.core.verify.certify``); a failed certificate marks its
columns ``"sdc_certificate"`` and gets one ladder pass.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.api.cache import HierarchyCache
from repro_torch.api.options import SolverOptions
from repro_torch.api.problem import Problem
from repro_torch.api.registry import get_backend, resolve_backend
from repro_torch.api.result import (SolveResult, STATUS_DEGRADED,
                                    STATUS_FAILED, has_breakdown,
                                    result_from_history, worst_status)
from repro_torch.testing.faults import InjectedFault

# What a rung may raise and the ladder records before it goes on: an
# injected fault, or a numerical failure of the rebuilt setup or the
# solve. Anything else — a kernel that does not build or launch, a bad
# argument — is not degraded around.
RUNG_ERRORS = (InjectedFault, ArithmeticError, np.linalg.LinAlgError,
               torch.linalg.LinAlgError)

# Registration side effect: importing the facade makes the built-ins
# available, so ``from repro_torch.api import solve; solve(...)`` works.
from repro_torch.api import backends as _backends


class Solver:
    """One multigrid setup, any number of (possibly blocked) solves.

    Construct with :func:`setup`. ``solver.stats()`` reports the
    hierarchy, ``solver.backend`` the resolved backend name.
    """

    def __init__(self, problem: Problem, options: SolverOptions,
                 backend: str, handle, setup_seconds: float,
                 mesh=None, cache: HierarchyCache | None = None):
        self.problem = problem
        self.options = options
        self.backend = backend
        self.setup_seconds = setup_seconds
        self._handle = handle
        self._mesh = mesh
        self._cache = cache
        # Admission-time conditioning triage (opt-in). Computed at
        # construction — i.e. at admission, cache hit or not — so the
        # routing decision exists before the first solve. The expensive
        # part of the score is memoized on the Problem.
        if options.triage:
            from repro_torch.api.triage import triage_problem

            self.triage = triage_problem(problem, options)
        else:
            self.triage = None

    # ------------------------------------------------------------------
    def _run(self, handle, B, tol, max_iters, x0, guard=None):
        """One solve attempt through a backend handle: the 4-tuple
        ``(X, norms, iters, statuses)``. ``guard`` overrides the handle's
        options-derived guard policy (the triage layer passes a tightened
        GuardConfig)."""
        kwargs = {}
        if x0 is not None:
            kwargs["x0"] = x0
        if guard is not None:
            kwargs["guard"] = guard
        return handle.solve_block(B, tol, max_iters, **kwargs)

    def solve(self, b, *, tol: float | None = None,
              max_iters: int | None = None, x0=None
              ) -> tuple[np.ndarray, SolveResult]:
        """Solve L x = b. ``b``: (n,) for one RHS or (n, k) for a block.

        ``tol``/``max_iters`` default to the solver's options. ``x0`` is
        an optional initial guess shaped like ``b`` (eager backends only;
        the default ``None`` starts from zeros, unchanged behavior).
        Returns ``(x, SolveResult)`` with ``x`` matching the shape of
        ``b``. On a Krylov breakdown the degradation ladder runs (see
        module docstring); inspect ``result.status`` / ``.diagnostics``.
        """
        tol = self.options.tol if tol is None else tol
        max_iters = self.options.max_iters if max_iters is None else max_iters
        b = np.asarray(b)
        single = b.ndim == 1
        B = b[:, None] if single else b
        if B.ndim != 2 or B.shape[0] != self.problem.n:
            raise ValueError(
                f"b must have shape ({self.problem.n},) or "
                f"({self.problem.n}, k), got {np.asarray(b).shape}")
        if x0 is not None:
            x0 = np.asarray(x0)
            if x0.shape != b.shape:
                raise ValueError(
                    f"x0 must match b's shape {b.shape}, got {x0.shape}")
            x0 = x0[:, None] if single else x0
        t0 = time.perf_counter()
        diagnostics: list = []
        status = None
        guard = None
        if self.triage is not None:
            diagnostics.append(self.triage.as_diagnostics())
            guard = self.triage.guard
        if self.triage is not None and self.triage.rung in ("diag_pcg",
                                                            "dense"):
            # triage routed AWAY from the multigrid path at admission —
            # go straight to the chosen ladder rung, no breakdown needed.
            X, norms, iters, statuses, wpi = self._triage_route(
                self.triage.rung, B, tol, max_iters, x0, diagnostics)
        else:
            X, norms, iters, statuses = self._run(self._handle, B, tol,
                                                  max_iters, x0,
                                                  guard=guard)
            wpi = self._handle.work_per_iteration
            if has_breakdown(statuses) and self.options.fallback:
                X, norms, iters, statuses, wpi, status = self._degrade(
                    B, tol, max_iters, x0, X, norms, iters, statuses,
                    diagnostics)
        if x0 is None:
            ref_norms = None
        else:
            # warm starts converge relative to ||proj b|| (the solver's
            # own reference), not the guess's possibly-tiny r0
            Bc = np.asarray(B, np.float64)
            ref_norms = np.linalg.norm(Bc - Bc.mean(axis=0, keepdims=True),
                                       axis=0)
        # Independent residual certification. The certificate is a
        # host float64 projected-residual check straight off the problem's
        # edge list — none of the device arrays the solve used are trusted.
        # A failed certificate marks the offending columns
        # "sdc_certificate" and (with fallback on) gets ONE ladder pass +
        # re-certification; a solve that still fails its certificate is
        # reported "failed", never silently returned.
        certificate = None
        if self.options.verify != "off":
            certificate = self._certify(B, X, tol, norms, ref_norms)
            if not certificate.passed:
                statuses = self._mark_cert_failure(statuses, certificate)
                if self.options.fallback and status != STATUS_FAILED:
                    X, norms, iters, statuses, wpi, status = self._degrade(
                        B, tol, max_iters, x0, X, norms, iters, statuses,
                        diagnostics)
                    certificate = self._certify(B, X, tol, norms, ref_norms)
                    if not certificate.passed:
                        statuses = self._mark_cert_failure(statuses,
                                                           certificate)
                        status = STATUS_FAILED
        solve_seconds = time.perf_counter() - t0
        result = result_from_history(
            self.backend, norms, iters, tol, wpi, self.setup_seconds,
            solve_seconds, ref_norms=ref_norms, statuses=statuses,
            diagnostics=tuple(diagnostics), status=status,
            certificate=certificate)
        return (X[:, 0] if single else X), result

    # ------------------------------------------------------------------
    def _certify(self, B, X, tol, norms, ref_norms):
        """Independent float64 certificate for the solve's claim, judged
        only on the columns that *claimed* convergence (an honest
        ``max_iters`` outcome is not silent corruption)."""
        from repro_torch.core.verify import certify

        norms_a = np.asarray(norms, np.float64)
        if norms_a.ndim == 1:
            norms_a = norms_a[:, None]
        ref = (norms_a[0] if ref_norms is None
               else np.asarray(ref_norms, np.float64))
        with np.errstate(invalid="ignore"):
            claimed = norms_a[-1] <= tol * ref
        return certify(self.problem, B, X, tol, claimed=claimed)

    @staticmethod
    def _mark_cert_failure(statuses, certificate):
        """Per-column statuses with certificate-failing columns marked
        ``"sdc_certificate"`` (building the array from the certificate's
        claim mask when the backend reported none)."""
        from repro_torch.core.krylov import (STATUS_CONVERGED,
                                             STATUS_MAX_ITERS,
                                             STATUS_SDC_CERT)

        if statuses is None:
            claimed = np.asarray(certificate.claimed, bool)
            sts = np.where(claimed, STATUS_CONVERGED,
                           STATUS_MAX_ITERS).astype("<U24")
        else:
            sts = np.asarray(statuses, dtype="<U24").copy()
        failed = np.asarray(certificate.failed_columns(), np.int64)
        sts[failed] = STATUS_SDC_CERT
        return sts

    # ------------------------------------------------------------------
    def _triage_route(self, rung, B, tol, max_iters, x0, diagnostics):
        """Run a triage-chosen non-multigrid rung directly. Returns
        ``(X, norms, iters, statuses, work_per_iteration)`` and appends a
        diagnostics entry per rung that ran (the ``stage="triage"`` entry
        is already in place)."""
        from repro_torch.api.fallback import (dense_solve_block,
                                              diag_pcg_block)

        opts = self.options

        def record(stage, sts):
            diagnostics.append(dict(
                stage=stage, status=worst_status(sts),
                statuses=np.asarray(sts).tolist(),
                recovered=not has_breakdown(sts)))

        if rung == "diag_pcg":
            X, norms, iters, statuses = diag_pcg_block(
                self.problem, B, tol, max_iters,
                guard=opts.guard_config() or False, x0=x0,
                device=opts.device)
            record("diag_pcg", statuses)
            if (has_breakdown(statuses) and opts.fallback
                    and self.problem.n <= opts.dense_fallback_max):
                X, norms, iters, statuses = dense_solve_block(
                    self.problem, B, tol)
                record("dense", statuses)
                return X, norms, iters, statuses, float(self.problem.n)
            return X, norms, iters, statuses, 1.0
        X, norms, iters, statuses = dense_solve_block(self.problem, B, tol)
        record("dense", statuses)
        return X, norms, iters, statuses, float(self.problem.n)

    # ------------------------------------------------------------------
    def _degrade(self, B, tol, max_iters, x0, X, norms, iters, statuses,
                 diagnostics):
        """Walk the degradation ladder after a breakdown. Returns the
        final ``(X, norms, iters, statuses, work_per_iteration, status)``
        and appends one diagnostics entry per rung that ran."""
        opts = self.options

        def record(stage, sts, note=None):
            diagnostics.append(dict(
                stage=stage, status=worst_status(sts),
                statuses=np.asarray(sts).tolist(),
                recovered=not has_breakdown(sts),
                **({} if note is None else dict(note=note))))

        record("primary", statuses)
        wpi = self._handle.work_per_iteration

        # rung 1: evict + rebuild the hierarchy, retry once ---------------
        note = None
        if self._cache is not None:
            n_inv = self._cache.invalidate(self.problem.fingerprint())
            note = f"invalidated {n_inv} cache entries"
        try:
            handle = get_backend(self.backend)(self.problem, opts, self._mesh)
            X, norms, iters, statuses = self._run(handle, B, tol,
                                                  max_iters, x0)
            wpi = handle.work_per_iteration
            record("rebuild", statuses, note)
            if not has_breakdown(statuses):
                # adopt (and re-cache) the healthy rebuild
                self._handle = handle
                if self._cache is not None:
                    self._cache.put(HierarchyCache.key(
                        self.problem, opts, self.backend, self._mesh),
                        handle)
                return X, norms, iters, statuses, wpi, STATUS_DEGRADED \
                    if worst_status(statuses) == "converged" else None
        except RUNG_ERRORS as e:                    # rebuild itself died
            record("rebuild", statuses, f"{note + '; ' if note else ''}"
                                        f"rebuild raised {e!r}")

        # rung 2: diagonal-preconditioned CG off the edge list ------------
        from repro_torch.api.fallback import diag_pcg_block

        try:
            X, norms, iters, statuses = diag_pcg_block(
                self.problem, B, tol, max_iters,
                guard=opts.guard_config() or False, x0=x0,
                device=opts.device)
            wpi = 1.0
            record("diag_pcg", statuses)
            if not has_breakdown(statuses):
                return X, norms, iters, statuses, wpi, STATUS_DEGRADED \
                    if worst_status(statuses) == "converged" else None
        except RUNG_ERRORS as e:
            record("diag_pcg", statuses, f"raised {e!r}")

        # rung 3: dense nullspace-aware direct solve (small n) ------------
        if self.problem.n <= opts.dense_fallback_max:
            from repro_torch.api.fallback import dense_solve_block

            try:
                X, norms, iters, statuses = dense_solve_block(
                    self.problem, B, tol)
                wpi = float(self.problem.n)
                record("dense", statuses)
                if not has_breakdown(statuses):
                    return X, norms, iters, statuses, wpi, STATUS_DEGRADED \
                        if worst_status(statuses) == "converged" else None
            except RUNG_ERRORS as e:
                record("dense", statuses, f"raised {e!r}")
        else:
            diagnostics.append(dict(
                stage="dense", status="skipped", statuses=[],
                recovered=False,
                note=f"n={self.problem.n} exceeds "
                     f"dense_fallback_max={opts.dense_fallback_max}"))

        return X, norms, iters, statuses, wpi, STATUS_FAILED

    def stats(self) -> dict:
        """Hierarchy statistics (per-level kind / size / nnz)."""
        return self._handle.stats()


# ----------------------------------------------------------------------
_DEFAULT_CACHE = HierarchyCache()


def default_cache() -> HierarchyCache:
    """The process-wide :class:`HierarchyCache` every ``setup()``/
    ``solve()`` call threads through unless told otherwise."""
    return _DEFAULT_CACHE


def setup(problem: Problem, options: SolverOptions | None = None,
          backend: str = "auto", mesh=None,
          cache: HierarchyCache | bool | None = None) -> Solver:
    """Build (or reuse) the multigrid hierarchy for ``problem``.

    ``backend`` is a registry name (``"single"``, ``"serial_ref"``,
    ``"dist"``) or ``"auto"``, which picks
    ``"dist"`` when a distributed context is available (a ``mesh`` was
    passed or more than one CUDA device is visible) and ``"single"``
    otherwise. ``mesh`` (a ``repro_torch.dist.ProcessMesh``) is only
    consumed by the dist backend; passing one forces it, and without one
    the dist backend takes ``default_mesh()``. The backend runs on
    ``options.device`` (default: the card).

    ``cache`` — hierarchies are content-addressed: by default the lookup
    goes through :func:`default_cache`, so a second ``setup()`` on an
    equal Problem (same :meth:`Problem.fingerprint`, options, backend,
    mesh) reuses the stored backend handle and does zero setup work
    (``setup_seconds == 0.0`` on the returned Solver). Pass a
    :class:`HierarchyCache` to use a private cache, or ``False`` to
    always rebuild.
    """
    if not isinstance(problem, Problem):
        raise TypeError(
            f"setup expects a repro_torch.api.Problem (see "
            f"Problem.from_edges), "
            f"got {type(problem).__name__}")
    options = options or SolverOptions()
    name = resolve_backend(backend, mesh, options)
    if mesh is not None and name != "dist":
        raise ValueError(
            f"a mesh is only consumed by the dist backend, but "
            f"backend={name!r} was requested")
    if name == "dist" and mesh is None:
        # before the cache lookup, so that the key names the process group
        # the handle reduces over
        mesh = _backends.default_mesh(options.device)
    # NB: identity checks, not truthiness — an *empty* HierarchyCache is
    # len() == 0 and must still be consulted/filled.
    if cache is None or cache is True:
        cache = _DEFAULT_CACHE
    elif cache is False:
        cache = None
    if cache is not None:
        key = HierarchyCache.key(problem, options, name, mesh)
        handle = cache.get(key)
        if handle is not None:
            return Solver(problem, options, name, handle, 0.0,
                          mesh=mesh, cache=cache)
    t0 = time.perf_counter()
    handle = get_backend(name)(problem, options, mesh)
    seconds = time.perf_counter() - t0
    if cache is not None:
        cache.put(key, handle)
    return Solver(problem, options, name, handle, seconds,
                  mesh=mesh, cache=cache)


def solve(problem: Problem, b, options: SolverOptions | None = None,
          backend: str = "auto", mesh=None,
          cache: HierarchyCache | bool | None = None
          ) -> tuple[np.ndarray, SolveResult]:
    """One-shot convenience: ``setup(...)`` then ``solve(b)``.

    Threads the hierarchy cache like :func:`setup`, so repeated one-shot
    ``solve()`` calls on an equal Problem only build the hierarchy once.
    For repeated right-hand sides prefer keeping the :class:`Solver` from
    :func:`setup` or batching them as the columns of ``b``.
    """
    return setup(problem, options, backend, mesh, cache=cache).solve(b)
