"""Krylov solvers: preconditioned CG with breakdown guards (paper §3; torch
port of ``repro.core.krylov``).

Three execution modes, as in the reference:

* ``pcg``         — eager loop with a stopping tolerance and the full
  residual history;
* ``pcg_block``   — k right-hand sides advanced in lockstep, each column
  converging, breaking down or being flagged on its own;
* ``pcg_scanned`` — a fixed ``n_iters`` loop that reads nothing back to
  the host, with the breakdown guards as device-side status lanes.

Graph Laplacians are singular, so residuals and preconditioned residuals
are projected mean-free every iteration (or per component, through
``project``). The guards only observe: a non-finite residual norm, an
indefinite or non-finite ``p·Ap``, or ``stagnation_window`` iterations
without relative improvement stop the solve (or the column) with an
explicit status, and a clean solve is bitwise the same with guards on or
off. ``check`` is an optional ABFT checksum (``repro_torch.core.verify``):
a flagged SpMV freezes the solve at its last trusted iterate with status
``"sdc_spmv"``; like the guards it only observes.

The ``solve.spmv`` / ``solve.precond`` / ``solve.residual`` fault sites
(``repro_torch.testing.faults``) sit where the reference has them, in the
same call order, so a plan's per-site call counts match the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.testing import faults

# Status codes of the eager solvers (SolveInfo.status and the per-column
# BlockSolveInfo.status). BREAKDOWN_STATUSES are the ones the facade's
# degradation ladder reacts to; "max_iters" is an honest non-convergence.
STATUS_CONVERGED = "converged"
STATUS_MAX_ITERS = "max_iters"
STATUS_NONFINITE = "breakdown_nonfinite"
STATUS_INDEFINITE = "breakdown_indefinite"
STATUS_STAGNATION = "stagnation"
# silent data corruption: the in-flight checksum flagged an SpMV
# ("sdc_spmv"), or the float64 certificate refused a claimed convergence
STATUS_SDC = "sdc_spmv"
STATUS_SDC_CERT = "sdc_certificate"

BREAKDOWN_STATUSES = frozenset(
    {STATUS_NONFINITE, STATUS_INDEFINITE, STATUS_STAGNATION,
     STATUS_SDC, STATUS_SDC_CERT})

# Device-side status codes of the scanned solve: one int32 per solve rides
# the loop instead of a host string. 0 = still healthy (resolved on the
# host into converged / max_iters from the final norms); nonzero = the
# guard that froze it.
SCAN_OK = 0
SCAN_NONFINITE = 2
SCAN_INDEFINITE = 3
SCAN_STAGNATION = 4
SCAN_SDC = 5

_SCAN_CODE_STATUS = {
    SCAN_NONFINITE: STATUS_NONFINITE,
    SCAN_INDEFINITE: STATUS_INDEFINITE,
    SCAN_STAGNATION: STATUS_STAGNATION,
    SCAN_SDC: STATUS_SDC,
}


def is_breakdown(status: str) -> bool:
    return status in BREAKDOWN_STATUSES


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


@dataclasses.dataclass
class BlockSolveInfo:
    """Per-column info of a blocked multi-RHS solve (``pcg_block``)."""

    iters: np.ndarray           # int64 [k] — iterations each column ran
    residual_norms: np.ndarray  # float [T+1, k] — lockstep residual history
    converged: np.ndarray       # bool [k]
    status: np.ndarray | None = None   # str [k] — per-column status codes


def _project(v: torch.Tensor) -> torch.Tensor:
    return v - v.mean()


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable | None = None,
        x0: torch.Tensor | None = None, tol: float = 1e-8,
        maxiter: int = 500, project: Callable | None = None, guard=True,
        check=None):
    """Eager PCG with residual history. Returns (x, SolveInfo).

    Each iteration reads two scalars on the host (‖r‖ and, when guarded
    or checked, ``p·Ap``), as the reference does; ``check(p, Ap)``'s
    verdict comes back in the same copy as ``p·Ap``.
    """
    proj = _project if project is None else project
    g = _as_guard(guard)
    b = proj(b)
    x = torch.zeros_like(b) if x0 is None else x0
    r = proj(b - matvec(x))
    M = precond if precond is not None else (lambda v: v)
    z = proj(faults.site("solve.precond", M(r)))
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
        Ap = faults.site("solve.spmv", matvec(p))
        pAp = torch.dot(p, Ap)
        if check is not None:
            pApf, bad = torch.stack([pAp, check(p, Ap).to(pAp.dtype)]
                                    ).cpu().tolist()
            if bad:
                # checksum mismatch: this Ap can't be trusted, freeze x at
                # the last trusted iterate before the poisoned update
                return x, SolveInfo(it, hist, False, STATUS_SDC)
            if g is not None and (not math.isfinite(pApf) or pApf <= 0.0):
                return x, SolveInfo(it, hist, False, STATUS_INDEFINITE)
        elif g is not None:
            pApf = float(pAp)
            if not math.isfinite(pApf) or pApf <= 0.0:
                # stop BEFORE applying the poisoned step
                return x, SolveInfo(it, hist, False, STATUS_INDEFINITE)
        alpha = rz / pAp
        x = x + alpha * p
        r = proj(faults.site("solve.residual", r - alpha * Ap))
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
        z = proj(faults.site("solve.precond", M(r)))
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
    return x, SolveInfo(maxiter, hist, False, STATUS_MAX_ITERS)


class _Columns:
    """A block as a list of k separate contiguous columns; the operators
    run a column at a time (the ELL kernels take one vector; a
    multi-column ELL SpMV is ROADMAP B1). With ``exact`` every column is
    driven by the very operations ``pcg`` applies to its one vector, so
    blocked columns are bitwise equal to looped ``pcg`` solves
    (``exact_columns=True``); otherwise means, dots and norms are 2-D
    reductions over the ``(n, k)`` block."""

    def __init__(self, matvec, M, project, exact=True):
        self.matvec, self.M, self.exact = matvec, M, exact
        self.project = project

    @staticmethod
    def split(B):
        return [B[:, j].contiguous() for j in range(B.shape[1])]

    @staticmethod
    def join(V):
        return torch.stack(V, dim=1)

    def site(self, name, V):
        if faults.active() is None:
            return V
        return self.split(faults.site(name, self.join(V)))

    def _lift(self, op, V, act):
        return [op(v) if a else torch.zeros_like(v) for v, a in zip(V, act)]

    def bmv(self, V, act):
        return self._lift(self.matvec, V, act)

    def bM(self, V, act):
        return self._lift(self.M, V, act)

    def proj(self, V):
        if self.project is not None:
            return [self.project(v) for v in V]
        if self.exact:
            return [_project(v) for v in V]
        J = self.join(V)
        return self.split(J - J.mean(dim=0, keepdim=True))

    @staticmethod
    def zeros_like(V):
        return [torch.zeros_like(v) for v in V]

    @staticmethod
    def sub(U, V):
        return [u - v for u, v in zip(U, V)]

    @staticmethod
    def axpy(X, a, P):                       # X + a·P
        return [x + a[j] * p for j, (x, p) in enumerate(zip(X, P))]

    @staticmethod
    def axmy(R, a, Q):                       # R − a·Q
        return [r - a[j] * q for j, (r, q) in enumerate(zip(R, Q))]

    @staticmethod
    def select(act, new, old):
        return [nw if a else od for a, nw, od in zip(act, new, old)]

    def cdot(self, U, V):
        if self.exact:
            return torch.stack([torch.dot(u, v) for u, v in zip(U, V)])
        return (self.join(U) * self.join(V)).sum(dim=0)

    def cnorm(self, V):
        if self.exact:
            return torch.stack([torch.linalg.norm(v) for v in V])
        return torch.linalg.vector_norm(self.join(V), dim=0)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def pcg_block(matvec: Callable, B: torch.Tensor,
              precond: Callable | None = None, tol: float = 1e-8,
              maxiter: int = 500, exact_columns: bool = True,
              x0: torch.Tensor | None = None,
              project: Callable | None = None, guard=True, check=None):
    """Blocked multi-RHS PCG: k single-RHS trajectories in lockstep.

    ``B`` is ``(n, k)``. ``matvec``, ``precond`` and ``project`` act on
    single length-n vectors and are lifted over the columns; all k solves
    share one iteration loop and one host read of the residual norms an
    iteration.

    ``exact_columns=True`` keeps every column a separate vector and
    computes every scalar (means, dots, norms) with the same 1-D
    operations ``pcg`` uses, so each column's iterates and solution are
    bitwise equal to a standalone ``pcg`` solve. ``exact_columns=False``
    computes the reductions over the ``(n, k)`` block at once (low-bit
    drift from the single-RHS trajectories).

    Columns converge independently: a column whose residual drops below
    ``tol * ||r0||`` freezes (zero step) while the rest keep iterating. The
    guards and ``check(P, Ap) -> bool[k]`` freeze a broken or flagged
    column at its last trusted iterate with its own status; the check's
    verdict comes back in the same copy as ``p·Ap``.

    ``tol`` and ``maxiter`` take a scalar or a per-column ``(k,)`` array;
    with arrays a column also freezes after its own ``maxiter[j]`` rounds.
    ``x0`` is an optional ``(n, k)`` block of initial guesses, used as is
    (no projection); warm starts stop relative to ``||proj b||``.
    ``x0=None`` starts from zeros.

    Returns ``(X, BlockSolveInfo)``: ``X`` is ``(n, k)`` on ``B``'s
    device; the ``(T+1, k)`` history holds a frozen column's last norm.
    """
    if B.dim() != 2:
        raise ValueError(f"pcg_block expects B of shape (n, k), got "
                         f"{tuple(B.shape)}")
    k = B.shape[1]
    g = _as_guard(guard)
    if np.ndim(tol):
        tol = np.asarray(tol)
        if tol.shape != (k,):
            raise ValueError(f"per-column tol must have shape ({k},), "
                             f"got {tol.shape}")
    if np.ndim(maxiter):
        maxiter = np.asarray(maxiter, np.int64)
        if maxiter.shape != (k,):
            raise ValueError(f"per-column maxiter must have shape ({k},), "
                             f"got {maxiter.shape}")
        n_rounds = int(maxiter.max(initial=0))
    else:
        n_rounds = maxiter
    M = precond if precond is not None else (lambda v: v)
    ops = _Columns(matvec, M, project, exact=exact_columns)

    all_cols = np.ones(k, bool)
    Bp = ops.proj(ops.split(B))
    if x0 is None:
        X = ops.zeros_like(Bp)
    else:
        if tuple(x0.shape) != tuple(B.shape):
            raise ValueError(f"x0 must match B's shape {tuple(B.shape)}, "
                             f"got {tuple(x0.shape)}")
        X = ops.split(x0.to(B.dtype))
    R = ops.proj(ops.sub(Bp, ops.bmv(X, all_cols)))
    Z = ops.proj(ops.site("solve.precond", ops.bM(R, all_cols)))
    P = Z
    rz = ops.cdot(R, Z)
    r0n = _host(ops.cnorm(R))
    hist = [r0n]
    status = np.full(k, "", dtype="<U24")
    if x0 is None:
        # a NaN r0n stays ACTIVE (every comparison with NaN is False) and
        # falls through to the guard below
        ref = r0n
        done0 = r0n == 0.0
    else:
        ref = _host(ops.cnorm(Bp))
        done0 = r0n <= tol * ref
    status[done0] = STATUS_CONVERGED
    active = ~done0
    if g is not None:
        dead = active & ~np.isfinite(r0n)
        if dead.any():
            status[dead] = STATUS_NONFINITE
            active = active & ~dead
    best = np.where(np.isfinite(r0n), r0n, np.inf)
    stall = np.zeros(k, np.int64)
    iters = np.zeros(k, np.int64)
    dev = B.device
    for _ in range(n_rounds):
        active = active & (iters < maxiter)
        if not active.any():
            break
        Ap = ops.site("solve.spmv", ops.bmv(P, active))
        pAp = ops.cdot(P, Ap)
        pApf = None
        if check is not None:
            # one copy brings back the checksum verdict and p·Ap
            both = _host(torch.cat([pAp, check(ops.join(P), ops.join(Ap))
                                    .to(pAp.dtype)]))
            pApf, sdc = both[:k], both[k:] != 0
            bad = active & sdc
            if bad.any():
                status[bad] = STATUS_SDC
                active = active & ~bad
                if not active.any():
                    break
        if g is not None:
            pApf = _host(pAp) if pApf is None else pApf
            bad = active & (~np.isfinite(pApf) | (pApf <= 0.0))
            if bad.any():
                # freeze the broken columns BEFORE the update
                status[bad] = STATUS_INDEFINITE
                active = active & ~bad
                if not active.any():
                    break
        act = torch.as_tensor(active, device=dev)
        iters += active
        alpha = torch.where(act, rz / pAp, 0.0)
        X = ops.axpy(X, alpha, P)
        # converged columns freeze exactly: re-projecting them would keep
        # shaving off the ~eps nullspace leak
        R = ops.select(active, ops.proj(ops.site(
            "solve.residual", ops.axmy(R, alpha, Ap))), R)
        rn = _host(ops.cnorm(R))
        hist.append(rn)
        just_done = active & (rn <= tol * ref)
        status[just_done] = STATUS_CONVERGED
        active = active & ~just_done
        if g is not None:
            dead = active & ~np.isfinite(rn)
            if dead.any():
                status[dead] = STATUS_NONFINITE
                active = active & ~dead
            improved = active & (rn < best * (1.0 - g.stagnation_rtol))
            best = np.where(improved, rn, best)
            stall = np.where(improved, 0, stall + active)
            stalled = active & (stall >= g.stagnation_window)
            if stalled.any():
                status[stalled] = STATUS_STAGNATION
                active = active & ~stalled
        Z = ops.select(active, ops.proj(ops.site(
            "solve.precond", ops.bM(R, active))), Z)
        rz_new = ops.cdot(R, Z)
        beta = torch.where(torch.as_tensor(active, device=dev), rz_new / rz,
                           0.0)
        P = ops.axpy(Z, beta, P)
        rz = rz_new
    norms = np.stack(hist)
    converged = norms[-1] <= tol * ref
    status[status == ""] = np.where(converged, STATUS_CONVERGED,
                                    STATUS_MAX_ITERS)[status == ""]
    return ops.join(X), BlockSolveInfo(iters=iters, residual_norms=norms,
                                       converged=converged, status=status)


def pcg_scanned(matvec: Callable, b: torch.Tensor,
                precond: Callable | None = None, n_iters: int = 50,
                project: Callable | None = None, guard=None,
                tol: float = 0.0):
    """Fixed-iteration PCG that never reads a value back to the host.

    With ``guard=None`` returns ``(x, residual_norms [n_iters+1])``. With
    ``guard`` a :class:`GuardConfig` (or True) the breakdown guards run
    inside the loop as 0-d device tensors — an int32 code, the best
    residual norm and a stall counter — and the return grows a third
    element, the code (one of the ``SCAN_*`` constants, a 0-d tensor).
    An indefinite or non-finite ``p·Ap`` freezes x BEFORE the poisoned
    update, a non-finite residual norm freezes after it, and
    ``stagnation_window`` iterations without relative improvement trip the
    stagnation lane; a frozen solve carries its state unchanged. On a
    clean trajectory every select picks the same float, so ``x`` and the
    norms are bitwise those of the unguarded loop.

    ``tol`` (guarded only) resets the stall counter once
    ``rn <= tol * r0n``: a solve at its accuracy floor below tolerance is
    finished, not stagnating.
    """
    proj = _project if project is None else project
    M = precond if precond is not None else (lambda v: v)
    g = _as_guard(guard)
    b = proj(b)
    x = torch.zeros_like(b)
    r = proj(b - matvec(x))
    z = proj(M(r))
    p = z
    rz = torch.dot(r, z)
    r0n = torch.linalg.norm(r)
    norms = [r0n]

    if g is None:
        for _ in range(n_iters):
            Ap = matvec(p)
            alpha = rz / torch.clamp(torch.dot(p, Ap), min=1e-30)
            x = x + alpha * p
            r = proj(r - alpha * Ap)
            z = proj(M(r))
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p = z + beta * p
            rz = rz_new
            norms.append(torch.linalg.norm(r))
        return x, torch.stack(norms)

    finite0 = torch.isfinite(r0n)
    code = torch.where(finite0, SCAN_OK, SCAN_NONFINITE).to(torch.int32)
    best = torch.where(finite0, r0n, math.inf)
    stall = torch.zeros((), dtype=torch.int32, device=b.device)
    for _ in range(n_iters):
        ok = code == SCAN_OK
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        indef = ok & ~(torch.isfinite(pAp) & (pAp > 0.0))
        code = torch.where(indef, SCAN_INDEFINITE, code)
        ok = ok & ~indef
        alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-30), 0.0)
        x = x + alpha * p
        r = torch.where(ok, proj(r - alpha * Ap), r)
        rn = torch.linalg.norm(r)
        nonf = ok & ~torch.isfinite(rn)
        code = torch.where(nonf, SCAN_NONFINITE, code)
        ok = ok & ~nonf
        improved = ok & (rn < best * (1.0 - g.stagnation_rtol))
        best = torch.where(improved, rn, best)
        conv = rn <= tol * r0n
        stall = torch.where(improved | conv, 0, stall + ok.to(torch.int32))
        stalled = ok & (stall >= g.stagnation_window)
        code = torch.where(stalled, SCAN_STAGNATION, code)
        ok = ok & ~stalled
        z = torch.where(ok, proj(M(r)), z)
        rz_new = torch.where(ok, torch.dot(r, z), rz)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = torch.where(ok, z + beta * p, p)
        rz = rz_new
        norms.append(rn)
    return x, torch.stack(norms), code


def scan_status_from_codes(codes, norms, tol, ref) -> np.ndarray:
    """Per-column status strings from in-scan device codes and the final
    norms: a nonzero code wins; a zero code resolves to ``"converged"``
    iff the final norm is within ``tol * ref``, else ``"max_iters"``."""
    if isinstance(codes, torch.Tensor):
        codes = _host(codes)
    codes = np.atleast_1d(np.asarray(codes))
    if isinstance(norms, torch.Tensor):
        norms = _host(norms)
    norms = np.asarray(norms, np.float64)
    if norms.ndim == 1:
        norms = norms[:, None]
    k = codes.shape[0]
    status = np.full(k, STATUS_MAX_ITERS, dtype="<U24")
    final = norms[-1]
    conv = np.isfinite(final) & (final <= np.asarray(tol) * np.asarray(ref))
    status[conv] = STATUS_CONVERGED
    for c, s in _SCAN_CODE_STATUS.items():
        status[codes == c] = s
    return status


def _norms_status(norms, tol, ref) -> np.ndarray:
    """Status codes from a residual history alone: the intended semantics
    of an unguarded scanned solve."""
    if isinstance(norms, torch.Tensor):
        norms = _host(norms)
    norms = np.asarray(norms, np.float64)
    if norms.ndim == 1:
        norms = norms[:, None]
    k = norms.shape[1]
    status = np.full(k, STATUS_MAX_ITERS, dtype="<U24")
    finite = np.isfinite(norms).all(axis=0)
    status[~finite] = STATUS_NONFINITE
    status[finite & (norms[-1] <= np.asarray(tol) * ref)] = STATUS_CONVERGED
    return status


def scan_norms_status(norms, tol, ref) -> np.ndarray:
    """Per-column status codes from a ``(T+1, k)`` scanned residual history.

    .. deprecated::
        A postmortem cross-check, as in the reference: the guarded scanned
        solve carries in-scan codes (:func:`scan_status_from_codes`),
        which see strictly more (an indefinite ``p·Ap`` is frozen before
        NaN reaches the norms, and stagnation never shows here).
    """
    warnings.warn(
        "scan_norms_status is a deprecated postmortem cross-check: the "
        "scanned solve carries in-scan breakdown codes "
        "(pcg_scanned(guard=...) -> scan_status_from_codes) which detect "
        "strictly more; use those instead",
        DeprecationWarning, stacklevel=2)
    return _norms_status(norms, tol, ref)
