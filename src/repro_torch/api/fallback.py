"""Last-resort solvers for the facade's degradation ladder (torch port of
``repro.api.fallback``).

When the multigrid-preconditioned solve breaks down (and a rebuilt
hierarchy breaks down again), the facade steps down to solvers with
strictly smaller trusted surfaces:

* :func:`diag_pcg_block` — CG preconditioned by diag(L)⁻¹, built directly
  from the Problem's edge list on the solver's device. No hierarchy: the
  only setup artifact it trusts is the degree vector. This is the paper's
  own baseline (Fig 3). Its SpMV is the deterministic segment sum of
  ``repro_torch.sparse.segment`` (one sort, reused every iteration),
  never an atomic float scatter.
* :func:`dense_solve_block` — a dense nullspace-aware direct solve in host
  float64, for small systems (``SolverOptions.dense_fallback_max``): it
  solves ``(L + α Σ_c J_c) x = P b`` where ``P`` removes per-component
  means, whose solution is the pseudo-inverse solution ``L⁺ P b``.

Both are nullspace-correct on disconnected graphs via
``Problem.components()`` and return the handle protocol's 4-tuple
``(X, norms, iters, statuses)`` with ``X`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.krylov import (STATUS_CONVERGED, STATUS_MAX_ITERS,
                                     STATUS_NONFINITE, GuardConfig,
                                     pcg_block)
from repro_torch.device import resolve_device


def _projector(problem, device):
    comp, n_comp = problem.components()
    if n_comp == 1:
        return None
    from repro_torch.core.components import component_projector

    return component_projector(comp, n_comp, device)


def diag_pcg_block(problem, B, tol, max_iters,
                   guard: GuardConfig | bool = True, x0=None, device=None):
    """Diagonal-preconditioned CG straight off the Problem's edge list, on
    ``device`` (default: the CUDA card)."""
    from repro_torch.sparse.segment import (per_row, segment_sum_plan,
                                            take_rows)

    dev = resolve_device(device)
    rows = torch.as_tensor(problem.rows, dtype=torch.int32, device=dev)
    cols = torch.as_tensor(problem.cols, dtype=torch.int64, device=dev)
    vals = torch.as_tensor(problem.vals, dtype=torch.float32, device=dev)
    deg = torch.as_tensor(problem.degrees().astype(np.float32), device=dev)
    inv_deg = 1.0 / torch.clamp(deg, min=1e-30)
    row_sum = segment_sum_plan(rows, problem.n)

    def matvec(V):                       # the whole (n, k) block at once
        return per_row(deg, V) * V - row_sum(per_row(vals, V)
                                             * take_rows(V, cols))

    def block(A):
        return torch.as_tensor(np.asarray(A), dtype=torch.float32,
                               device=dev)

    X, info = pcg_block(matvec, block(B),
                        precond=lambda R: per_row(inv_deg, R) * R,
                        tol=tol, maxiter=max_iters, exact_columns=False,
                        x0=None if x0 is None else block(x0),
                        project=_projector(problem, dev), guard=guard)
    return (X.cpu().numpy(), np.asarray(info.residual_norms),
            np.asarray(info.iters, np.int64), info.status)


def dense_solve_block(problem, B, tol):
    """Dense float64 nullspace-aware direct solve (small n only)."""
    n = problem.n
    L = np.zeros((n, n), np.float64)
    r, c = problem.rows, problem.cols
    v = np.asarray(problem.vals, np.float64)
    np.add.at(L, (r, r), v)           # degrees (both directions stored)
    np.subtract.at(L, (r, c), v)
    comp, n_comp = problem.components()
    counts = np.bincount(comp, minlength=n_comp).astype(np.float64)
    alpha = float(L.trace() / n) or 1.0
    reg = (comp[:, None] == comp[None, :]) / counts[comp][:, None]

    B = np.asarray(B, np.float64)
    single = B.ndim == 1
    if single:
        B = B[:, None]
    means = np.zeros((n_comp, B.shape[1]))
    np.add.at(means, comp, B)
    Bp = B - (means / counts[:, None])[comp]
    X = np.linalg.solve(L + alpha * reg, Bp)

    r0n = np.linalg.norm(Bp, axis=0)
    rn = np.linalg.norm(Bp - L @ X, axis=0)
    norms = np.stack([r0n, rn])
    with np.errstate(invalid="ignore"):
        ok = rn <= np.asarray(tol) * r0n
    statuses = np.where(ok, STATUS_CONVERGED, STATUS_MAX_ITERS
                        ).astype("<U24")
    # a non-finite RHS that survived to the last rung is a breakdown, not
    # clean math that ran out of iterations
    statuses[~(np.isfinite(r0n) & np.isfinite(rn))] = STATUS_NONFINITE
    return (X[:, 0] if single else X, norms,
            np.ones(B.shape[1], np.int64), statuses)
