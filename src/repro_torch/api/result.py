"""``SolveResult``: identical result fields for every backend (torch port
of ``repro.api.result``).

Whatever backend ran, the caller gets the same fields with the same
meanings, for one right-hand side or a block of them: the residual
history, iteration counts, ``status`` (the overall outcome code),
``statuses`` (per-column Krylov status codes when the backend reports
them), ``diagnostics`` (the rungs of the facade's degradation ladder that
ran) and the float64 ``certificate``. A clean converged solve reports
``status="converged"`` and empty diagnostics.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.krylov import (BREAKDOWN_STATUSES, STATUS_CONVERGED,
                                     STATUS_MAX_ITERS)
from repro_torch.core.verify import Certificate
from repro_torch.core.wda import wda as _wda

# Overall-outcome codes beyond the Krylov layer's own:
STATUS_DEGRADED = "degraded"   # a ladder rung recovered the solve
STATUS_FAILED = "failed"       # breakdown and every rung exhausted


def worst_status(statuses) -> str:
    """Collapse per-column status codes to the block's overall code.

    Severity order: sdc (detected silent corruption is the worst possible
    news) > non-finite > indefinite > stagnation > max_iters > converged —
    a block is only "converged" when every column is.
    """
    order = ("sdc_spmv", "sdc_certificate",
             "breakdown_nonfinite", "breakdown_indefinite", "stagnation",
             STATUS_MAX_ITERS, STATUS_CONVERGED)
    seen = set(str(s) for s in np.asarray(statuses).ravel())
    for code in order:
        if code in seen:
            return code
    return STATUS_CONVERGED


def has_breakdown(statuses) -> bool:
    return bool(statuses is not None
                and worst_status(statuses) in BREAKDOWN_STATUSES)


@dataclasses.dataclass(frozen=True, eq=False)
class SolveResult:
    """Outcome of one ``solve`` call, backend-independent.

    * ``backend`` — registry name that ran (``"auto"`` is resolved first),
    * ``converged`` — every right-hand side reached ``tol``,
    * ``iters`` — PCG iterations of the slowest column,
    * ``iters_per_rhs`` — per-column iteration counts, shape (k,),
    * ``residual_norms`` — lockstep residual history, shape (iters+1, k)
      (converged columns hold their frozen final norm),
    * ``wda`` — Work per Digit of Accuracy (paper Fig 3 metric) over the
      block residual (Frobenius norm history),
    * ``work_per_iteration`` — one PCG iteration's cost in finest-level
      matvec equivalents,
    * ``setup_seconds`` / ``solve_seconds`` — wall-clock (setup is the
      hierarchy build of the owning ``Solver``, amortised over its solves),
    * ``n_rhs`` — number of right-hand sides (k),
    * ``status`` — overall outcome code: ``"converged"``, ``"max_iters"``
      (honest non-convergence), a breakdown code
      (``"breakdown_nonfinite"`` / ``"breakdown_indefinite"`` /
      ``"stagnation"``), ``"degraded"`` (a breakdown recovered by the
      facade's fallback ladder) or ``"failed"`` (ladder exhausted),
    * ``statuses`` — per-column Krylov status codes, shape (k,), or None
      when the backend doesn't report them (third-party handles),
    * ``diagnostics`` — tuple of dicts, one per degradation-ladder rung
      that ran (empty for a clean solve); each records the ``stage``, its
      per-column ``statuses`` and whether it ``recovered``,
    * ``certificate`` — with ``SolverOptions(verify=...)`` on, the
      independent float64 projected-residual certificate
      (``repro_torch.core.verify.Certificate``); ``None`` with
      ``verify="off"``.
    """

    backend: str
    converged: bool
    iters: int
    iters_per_rhs: np.ndarray
    residual_norms: np.ndarray
    wda: float
    work_per_iteration: float
    setup_seconds: float
    solve_seconds: float
    n_rhs: int
    status: str = STATUS_CONVERGED
    statuses: np.ndarray | None = None
    diagnostics: tuple = ()
    certificate: Certificate | None = None


def result_from_history(backend: str, norms: np.ndarray,
                        iters_per_rhs: np.ndarray, tol: float,
                        work_per_iteration: float, setup_seconds: float,
                        solve_seconds: float,
                        ref_norms: np.ndarray | None = None,
                        statuses=None, diagnostics: tuple = (),
                        status: str | None = None,
                        certificate: Certificate | None = None
                        ) -> SolveResult:
    """Assemble a ``SolveResult`` from a (T+1, k) residual history.

    Trims the history at the slowest column's convergence point (frozen
    tails would otherwise inflate the WDA iteration count) and derives
    convergence from the tolerance: a column converged iff its final norm
    is within ``tol`` of its initial norm — or of ``ref_norms`` when
    given (warm-started solves measure against ``||proj b||``, not the
    initial guess's own residual).

    ``status`` defaults to the worst per-column code in ``statuses``, or
    to converged/max_iters derived from the residuals when the backend
    reported no codes. The facade overrides it with ``"degraded"`` /
    ``"failed"`` after running its ladder.
    """
    norms = np.asarray(norms, np.float64)
    if norms.ndim == 1:
        norms = norms[:, None]
    iters_per_rhs = np.asarray(iters_per_rhs, np.int64)
    it_max = int(iters_per_rhs.max()) if iters_per_rhs.size else 0
    norms = norms[: it_max + 1]
    ref = (norms[0] if ref_norms is None
           else np.asarray(ref_norms, np.float64))
    with np.errstate(invalid="ignore"):
        converged = bool(np.all(norms[-1] <= tol * ref))
    if statuses is not None:
        statuses = np.asarray(statuses)
    if status is None:
        if statuses is not None:
            status = worst_status(statuses)
        else:
            status = STATUS_CONVERGED if converged else STATUS_MAX_ITERS
    frob = np.sqrt((norms ** 2).sum(axis=1))
    return SolveResult(
        backend=backend, converged=converged, iters=it_max,
        iters_per_rhs=iters_per_rhs, residual_norms=norms,
        wda=_wda(frob.tolist(), work_per_iteration),
        work_per_iteration=float(work_per_iteration),
        setup_seconds=float(setup_seconds),
        solve_seconds=float(solve_seconds), n_rhs=norms.shape[1],
        status=status, statuses=statuses, diagnostics=tuple(diagnostics),
        certificate=certificate)
