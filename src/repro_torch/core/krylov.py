"""Preconditioned CG with breakdown guards (paper §3; torch port of
``repro.core.krylov.pcg``).

Graph Laplacians are singular, so residuals and preconditioned residuals
are projected mean-free every iteration (or per component, through
``project``). The guards only observe: a non-finite residual norm, an
indefinite or non-finite ``p·Ap``, or ``stagnation_window`` iterations
without relative improvement stop the solve with an explicit status, and
a clean solve is bitwise the same with guards on or off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

STATUS_CONVERGED = "converged"
STATUS_MAX_ITERS = "max_iters"
STATUS_NONFINITE = "breakdown_nonfinite"
STATUS_INDEFINITE = "breakdown_indefinite"
STATUS_STAGNATION = "stagnation"


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """``stagnation_window`` iterations without the best residual improving
    by a relative ``stagnation_rtol`` trips the stagnation guard."""

    stagnation_window: int = 50
    stagnation_rtol: float = 1e-4


def _as_guard(guard) -> GuardConfig | None:
    if guard is None or guard is False:
        return None
    if guard is True:
        return GuardConfig()
    return guard


@dataclasses.dataclass
class SolveInfo:
    iters: int
    residual_norms: list
    converged: bool
    status: str = STATUS_MAX_ITERS


def _project(v: torch.Tensor) -> torch.Tensor:
    return v - v.mean()


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable | None = None,
        x0: torch.Tensor | None = None, tol: float = 1e-8,
        maxiter: int = 500, project: Callable | None = None, guard=True):
    """Eager PCG with residual history. Returns (x, SolveInfo).

    Each iteration reads two scalars on the host (‖r‖ and, when guarded,
    ``p·Ap``), as the reference does.
    """
    proj = _project if project is None else project
    g = _as_guard(guard)
    b = proj(b)
    x = torch.zeros_like(b) if x0 is None else x0
    r = proj(b - matvec(x))
    M = precond if precond is not None else (lambda v: v)
    z = proj(M(r))
    p = z
    rz = torch.dot(r, z)
    r0n = float(torch.linalg.norm(r))
    hist = [r0n]
    if r0n == 0:
        return x, SolveInfo(0, hist, True, STATUS_CONVERGED)
    if g is not None and not math.isfinite(r0n):
        return x, SolveInfo(0, hist, False, STATUS_NONFINITE)
    best, stall = r0n, 0
    for it in range(maxiter):
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        if g is not None:
            pApf = float(pAp)
            if not math.isfinite(pApf) or pApf <= 0.0:
                # stop BEFORE applying the poisoned step
                return x, SolveInfo(it, hist, False, STATUS_INDEFINITE)
        alpha = rz / pAp
        x = x + alpha * p
        r = proj(r - alpha * Ap)
        rn = float(torch.linalg.norm(r))
        hist.append(rn)
        if rn <= tol * r0n:
            return x, SolveInfo(it + 1, hist, True, STATUS_CONVERGED)
        if g is not None:
            if not math.isfinite(rn):
                return x, SolveInfo(it + 1, hist, False, STATUS_NONFINITE)
            if rn < best * (1.0 - g.stagnation_rtol):
                best, stall = rn, 0
            else:
                stall += 1
                if stall >= g.stagnation_window:
                    return x, SolveInfo(it + 1, hist, False,
                                        STATUS_STAGNATION)
        z = proj(M(r))
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
    return x, SolveInfo(maxiter, hist, False, STATUS_MAX_ITERS)

