"""Multigrid-preconditioned LOBPCG for the k smallest nontrivial Laplacian
eigenpairs (torch port of ``repro.spectral.lobpcg``).

LAMG's own thesis (Livne & Brandt, arXiv:1108.0123) is that a Laplacian AMG
hierarchy is precisely the right preconditioner for spectral computations:
the V-cycle damps exactly the high-frequency error the low eigenvectors
don't contain. This module rides the ``repro_torch.api`` facade end-to-end —
one cached multigrid hierarchy (``setup`` threads :class:`~repro_torch.api.
cache.HierarchyCache`, so repeated spectral calls on the same graph build it
once), and every preconditioner application is a blocked ``solve_block``
call (k columns, few PCG iterations) on the card, the traffic shape the
serving layer batches. Everything else is host numpy/scipy float64, as in
the reference.

Design:

* **constant-vector deflation** — connected Laplacians have nullspace
  span{1}; every basis block is kept mean-free, so the solver converges to
  the smallest *nontrivial* pairs without ever forming the trivial one.
* **soft locking** — converged columns' residuals are zeroed out of the
  search-direction block but their Ritz vectors stay in the Rayleigh–Ritz
  basis, so later columns keep orthogonalizing against them and the block
  shapes never change.
* **fixed block shapes, per-column stopping** — the device-facing
  operator (the blocked preconditioner solves) always sees ``(n, k)``
  blocks and the trial basis is always ``[X | W | P]`` of width ``3k``;
  a column is converged once ``||r_j|| <= tol * ||r0_j||``,
  ``pcg_block``'s own criterion. The small dense Rayleigh–Ritz algebra
  runs in float64 on host so eigenvalues come out at oracle precision
  regardless of the float32 solve path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EigResult", "lobpcg", "refine_eigenpairs"]


@dataclasses.dataclass(frozen=True, eq=False)
class EigResult:
    """Outcome of a blocked Laplacian eigensolve.

    * ``eigenvalues`` — (k,) float64, ascending, smallest nontrivial first,
    * ``eigenvectors`` — (n, k) float64, orthonormal, mean-free,
    * ``iters`` — outer LOBPCG iterations run,
    * ``iters_per_pair`` — (k,) iteration at which each pair converged,
    * ``residual_norms`` — (iters+1, k) lockstep residual history
      (converged columns hold their frozen norm, as in ``pcg_block``),
    * ``converged`` — (k,) bool,
    * ``backend`` — preconditioner backend name, or ``"none"``,
    * ``precond_solves`` / ``precond_columns`` — how many blocked
      ``solve_block`` applications the preconditioner issued and the total
      RHS columns they carried (the solve-block occupancy the benchmark
      reports),
    * ``precond_status`` — the worst overall status any preconditioner
      application reported (``"converged"`` < ``"max_iters"`` <
      ``"degraded"`` < ``"failed"``; see ``SolveResult.status``). Inner
      solves are truncated at ``inner_iters`` by design, so
      ``"max_iters"`` here is normal; ``"degraded"``/``"failed"`` mean the
      facade's ladder ran — a failed application falls back to the
      unpreconditioned direction (W = R) for that iteration, so the
      eigensolve itself still converges on clean math,
    * ``setup_seconds`` — hierarchy build wall time (0.0 on a cache hit).
    """

    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    iters: int
    iters_per_pair: np.ndarray
    residual_norms: np.ndarray
    converged: np.ndarray
    backend: str
    precond_solves: int
    precond_columns: int
    setup_seconds: float
    precond_status: str = "converged"


# severity ladder for the worst-status collapse over inner solves
_STATUS_RANK = {"converged": 0, "max_iters": 1, "degraded": 2, "failed": 3}


def _default_options(n: int, device):
    """The preconditioner's options when the caller passes none: the
    throughput path (``exact_columns=False``: eigensolves don't need
    bitwise column reproducibility), with ``coarsest_size`` below n so
    small validation graphs still get a real hierarchy, on ``device``
    (None = the CUDA card)."""
    from repro_torch.api import SolverOptions

    return SolverOptions(exact_columns=False,
                         coarsest_size=min(128, max(n // 2, 2)),
                         device=device)


def _laplacian_csr(problem):
    """Dense-free float64 Laplacian operator: L = diag(deg) - A."""
    import scipy.sparse as sp

    n = problem.n
    a = sp.csr_matrix(
        (np.asarray(problem.vals, np.float64),
         (np.asarray(problem.rows), np.asarray(problem.cols))),
        shape=(n, n))
    return sp.diags(np.asarray(problem.degrees(), np.float64)) - a


def _deflate(V):
    """Project the constant vector (the Laplacian nullspace) out of V."""
    return V - V.mean(axis=0, keepdims=True)


def _orthonormal_columns(V, rng, eps=1e-12):
    """QR-orthonormalize; reseed (mean-free) any numerically null column."""
    q, r = np.linalg.qr(V)
    bad = np.abs(np.diag(r)) <= eps * max(1.0, np.abs(np.diag(r)).max())
    if bad.any():
        q[:, bad] = _deflate(rng.standard_normal((V.shape[0], bad.sum())))
        q, _ = np.linalg.qr(q)
    return q


def _rayleigh_ritz(S, LS, k, eps_rank=1e-8):
    """Rank-revealing Rayleigh–Ritz on the (fixed-width) trial basis S.

    Whitens S through the eigendecomposition of its Gram matrix (dropping
    numerically dependent directions — zeroed soft-locked residuals land
    here), solves the small dense eigenproblem in float64, and returns the
    k smallest Ritz pairs plus the coefficient matrix C with X_new = S @ C.
    L is PSD, so negative Ritz values can only be whitening-amplified
    noise — they are excluded from selection rather than allowed to shadow
    the true smallest pairs.
    """
    G = S.T @ S
    w, U = np.linalg.eigh((G + G.T) / 2)
    keep = w > eps_rank * max(w.max(), 1e-300)
    T = U[:, keep] / np.sqrt(w[keep])
    H = T.T @ (S.T @ LS) @ T
    mu, Y = np.linalg.eigh((H + H.T) / 2)
    ok = mu > -1e-8 * max(abs(mu).max(), 1e-300)
    mu, Y = mu[ok], Y[:, ok]
    m = min(k, Y.shape[1])
    C = T @ Y[:, :m]
    if m < k:                       # basis collapsed below k (tiny graphs)
        C = np.pad(C, ((0, 0), (0, k - m)))
    return mu[:m], C


def lobpcg(problem, k: int = 8, *, options=None, backend: str = "auto",
           mesh=None, cache=None, tol: float = 1e-6, max_iters: int = 200,
           precondition: bool = True, inner_tol: float = 1e-3,
           inner_iters: int = 12, X0=None, seed: int = 0,
           device=None) -> EigResult:
    """k smallest nontrivial eigenpairs of the graph Laplacian of ``problem``.

    ``options``/``backend``/``mesh``/``cache`` configure the multigrid
    preconditioner exactly as :func:`repro_torch.api.setup` does (the
    ``single`` and ``serial_ref`` backends; ``dist`` is not ported), and
    the hierarchy is content-addressed so repeated spectral calls on one
    graph set up once.
    When ``options`` is ``None`` the preconditioner uses the throughput
    path (``exact_columns=False``) — eigensolves don't need bitwise
    column reproducibility — on ``device`` (default: the CUDA card;
    ``device="cpu"`` for the host). ``device`` fills only those default
    options; passed ``options`` carry their own.

    Each preconditioner application is one blocked ``solve_block`` with
    ``inner_iters``/``inner_tol`` stopping (an inexact L⁺ apply — the
    standard AMG-preconditioned LOBPCG construction). ``precondition=False``
    runs the unpreconditioned method (W = R), the benchmark baseline.

    ``X0`` is an optional (n, k) warm-start block (incremental embeddings
    pass the previous eigenvectors). ``tol`` stops pair j once
    ``||r_j|| <= tol * max(||r0_j||, ||L z||)`` with ``z`` a seeded random
    unit probe — the relative criterion of ``pcg_block`` clamped from
    below by the residual scale of a cold random start, so warm-started
    columns that are already converged exit immediately instead of
    chasing ``tol`` times their own tiny initial residual.
    """
    n = int(problem.n)
    if not 1 <= k:
        raise ValueError(f"k must be >= 1, got {k}")
    if 3 * k + 1 > n:
        raise ValueError(
            f"k={k} needs a 3k-wide trial basis plus the constant nullspace "
            f"but the graph has only n={n} vertices; use k <= {(n - 1) // 3} "
            f"or a dense eigensolver")
    L = _laplacian_csr(problem)
    rng = np.random.default_rng(seed)

    solver = None
    setup_seconds = 0.0
    backend_name = "none"
    if precondition:
        from repro_torch.api import setup

        if options is None:
            options = _default_options(n, device)
        solver = setup(problem, options, backend=backend, mesh=mesh,
                       cache=cache)
        setup_seconds = solver.setup_seconds
        backend_name = solver.backend

    precond_solves = 0
    precond_columns = 0
    precond_status = "converged"

    def apply_T(R):
        """Inexact L⁺ apply: one blocked multigrid solve per call."""
        nonlocal precond_solves, precond_columns, precond_status
        if solver is None:
            return R.copy()
        W, res = solver.solve(R.astype(np.float32), tol=inner_tol,
                              max_iters=inner_iters)
        precond_solves += 1
        # occupancy accounting: soft-locked columns ride along as zeros in
        # the fixed-shape block; only the nonzero columns are live work
        precond_columns += int((np.abs(R).max(axis=0) > 0).sum())
        if _STATUS_RANK.get(res.status, 3) > _STATUS_RANK[precond_status]:
            precond_status = res.status
        W = np.asarray(W, np.float64)
        if res.status == "failed" or not np.isfinite(W).all():
            # the ladder is exhausted for this application: preconditioning
            # only accelerates, so fall back to the unpreconditioned
            # direction rather than poisoning the trial basis
            return R.copy()
        return W

    if X0 is not None:
        X = np.asarray(X0, np.float64)
        if X.shape != (n, k):
            raise ValueError(f"X0 must have shape ({n}, {k}), got {X.shape}")
        X = X.copy()
    else:
        X = rng.standard_normal((n, k))
    X = _orthonormal_columns(_deflate(X), rng)
    LX = L @ X
    # initial Rayleigh-Ritz so theta/X are consistent before iteration one
    mu, C = _rayleigh_ritz(X, LX, k)
    X, LX = X @ C, LX @ C
    theta = np.sum(X * LX, axis=0)
    R = LX - X * theta[None, :]
    r0n = np.linalg.norm(R, axis=0)
    # stopping reference: a warm start's r0 can be arbitrarily small, so
    # clamp by the residual scale of a cold random start (one probe SpMV)
    z = _deflate(rng.standard_normal((n, 1)))
    z /= max(np.linalg.norm(z), 1e-300)
    r_ref = np.maximum(r0n, np.linalg.norm(L @ z))
    hist = [r0n]
    active = r0n > tol * r_ref
    iters_per_pair = np.zeros(k, np.int64)
    P = LP = None
    n_iters = 0
    for _ in range(max_iters):
        if not active.any():
            break
        n_iters += 1
        iters_per_pair += active
        # soft locking: converged columns contribute no search direction
        # but stay in the basis (R's columns zeroed, X's kept).
        W = apply_T(np.where(active[None, :], R, 0.0))
        W = _deflate(np.where(active[None, :], W, 0.0))
        # orthogonalize the new directions against the current Ritz block
        # and normalize columns (tiny-norm directions would otherwise be
        # whitening-amplified into pure noise); the rank-revealing RR
        # handles the rest.
        W -= X @ (X.T @ W)
        wn = np.linalg.norm(W, axis=0)
        ok = wn > 1e-300
        W[:, ok] /= wn[ok][None, :]
        W[:, ~ok] = 0.0
        LW = L @ W
        if P is None:
            S = np.concatenate([X, W], axis=1)
            LS = np.concatenate([LX, LW], axis=1)
        else:
            S = np.concatenate([X, W, P], axis=1)
            LS = np.concatenate([LX, LW, LP], axis=1)
        mu, C = _rayleigh_ritz(S, LS, k)
        X_new, LX_new = S @ C, LS @ C
        # implicit P: the non-X part of the new Ritz vectors
        Cp = C.copy()
        Cp[:k, :] = 0.0
        P, LP = S @ Cp, LS @ Cp
        pn = np.linalg.norm(P, axis=0)
        ok = pn > 1e-300
        P[:, ok] /= pn[ok][None, :]
        LP[:, ok] /= pn[ok][None, :]
        P[:, ~ok] = 0.0
        LP[:, ~ok] = 0.0
        X, LX = X_new, LX_new
        theta = np.sum(X * LX, axis=0)
        R = LX - X * theta[None, :]
        rn = np.linalg.norm(R, axis=0)
        # frozen history, pcg_block-style: converged columns hold position
        rn = np.where(active, rn, hist[-1])
        hist.append(rn)
        active = active & (rn > tol * r_ref)
    order = np.argsort(theta)
    norms = np.stack(hist)
    return EigResult(
        eigenvalues=theta[order],
        eigenvectors=_orthonormal_columns(_deflate(X[:, order]), rng),
        iters=n_iters,
        iters_per_pair=iters_per_pair[order],
        residual_norms=norms[:, order],
        converged=(norms[-1] <= tol * np.maximum(r_ref, 1e-300))[order],
        backend=backend_name,
        precond_solves=precond_solves,
        precond_columns=precond_columns,
        setup_seconds=setup_seconds,
        precond_status=precond_status)


def refine_eigenpairs(problem, result: EigResult, *, options=None,
                      backend: str = "auto", mesh=None, cache=None,
                      inner_tol: float = 1e-6, inner_iters: int = 30,
                      device=None) -> EigResult:
    """One inverse-iteration polish of converged eigenpairs.

    Solves ``L Y = X diag(lambda)`` warm-started from ``x0 = X`` — since
    ``L X ≈ X diag(lambda)`` already, the x0 block makes each column's
    solve start essentially converged (this is the ``solve_block`` x0
    consumer the satellite API exists for) — then re-runs one
    Rayleigh–Ritz on the refined block. ``device`` fills only the default
    options, as in :func:`lobpcg`.
    """
    from repro_torch.api import setup

    if options is None:
        options = _default_options(problem.n, device)
    solver = setup(problem, options, backend=backend, mesh=mesh, cache=cache)
    X = np.asarray(result.eigenvectors, np.float64)
    lam = np.asarray(result.eigenvalues, np.float64)
    B = (X * lam[None, :]).astype(np.float32)
    Y, _ = solver.solve(B, tol=inner_tol, max_iters=inner_iters,
                        x0=X.astype(np.float32))
    rng = np.random.default_rng(0)
    Y = _orthonormal_columns(_deflate(np.asarray(Y, np.float64)), rng)
    L = _laplacian_csr(problem)
    LY = L @ Y
    mu, C = _rayleigh_ritz(Y, LY, X.shape[1])
    Xr, LXr = Y @ C, LY @ C
    theta = np.sum(Xr * LXr, axis=0)
    order = np.argsort(theta)
    R = LXr - Xr * theta[None, :]
    rn = np.linalg.norm(R, axis=0)
    return dataclasses.replace(
        result,
        eigenvalues=theta[order],
        eigenvectors=_orthonormal_columns(_deflate(Xr[:, order]), rng),
        residual_norms=np.concatenate(
            [result.residual_norms, rn[None, order]], axis=0),
        backend=solver.backend)
