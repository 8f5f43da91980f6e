"""Effective resistance via the Spielman–Srivastava sketch (torch port of
``repro.spectral.resistance``).

R_eff(u, v) = (e_u - e_v)^T L⁺ (e_u - e_v) is the workhorse quantity
behind spectral sparsification, commute times, and edge centrality. The
Spielman–Srivastava observation: R_eff(u, v) = ||W^{1/2} B L⁺ (e_u-e_v)||²
with B the signed incidence matrix, so a Johnson–Lindenstrauss projection
Q (q = O(log n / eps²) rows of random signs) preserves all pairwise
resistances to (1 ± eps) — and computing Z = L⁺ (B^T W^{1/2} Q^T) is just
**q Laplacian solves against random signed-incidence right-hand sides**:
one blocked ``solve_block`` call on the cached multigrid hierarchy, the
purest many-RHS consumer in the repo.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["ResistanceSketch", "effective_resistance",
           "exact_effective_resistance"]


@dataclasses.dataclass(frozen=True, eq=False)
class ResistanceSketch:
    """A resistance oracle: ``query(u, v)`` ≈ R_eff(u, v) to (1 ± eps).

    ``Z`` is the (n, q) sketch — vertex u's resistance profile is row u;
    ``n_probes`` = q; ``solve_iters`` the PCG iterations the blocked solve
    took (the many-RHS stress number).
    """

    Z: np.ndarray
    n_probes: int
    eps: float
    solve_iters: int
    backend: str

    def query(self, u, v) -> np.ndarray:
        """Approximate R_eff for vertex pairs; broadcasts like numpy."""
        u = np.asarray(u)
        v = np.asarray(v)
        d = self.Z[u] - self.Z[v]
        return np.asarray((d * d).sum(axis=-1))


def _incidence_rhs(problem, q: int, seed: int) -> np.ndarray:
    """B^T W^{1/2} Q^T for a random ±1/√q JL matrix Q, as an (n, q) block.

    Column i is sum_e s_{e,i} sqrt(w_e) (e_u - e_v) / sqrt(q) over the
    undirected edges — each column is mean-free by construction, exactly
    the range-of-L right-hand sides the solver wants.
    """
    rng = np.random.default_rng(seed)
    once = problem.rows < problem.cols          # each undirected edge once
    u = problem.rows[once]
    v = problem.cols[once]
    w = np.sqrt(np.asarray(problem.vals, np.float64)[once])
    m = len(u)
    B = np.zeros((problem.n, q), np.float64)
    signs = rng.integers(0, 2, size=(m, q)).astype(np.float64) * 2.0 - 1.0
    contrib = signs * w[:, None] / math.sqrt(q)
    np.add.at(B, u, contrib)
    np.add.at(B, v, -contrib)
    return B


def effective_resistance(problem, *, eps: float = 0.3,
                         n_probes: int | None = None, seed: int = 0,
                         options=None, backend: str = "auto", mesh=None,
                         cache=None, tol: float = 1e-8,
                         max_iters: int = 300,
                         device=None) -> ResistanceSketch:
    """Build a Spielman–Srivastava resistance sketch for ``problem``.

    ``n_probes`` defaults to ``ceil(8 ln n / eps²)`` (the JL dimension; cap
    it yourself for very small eps). The whole computation is one blocked
    ``solve_block`` with ``n_probes`` columns against the cached multigrid
    hierarchy — solver keyword arguments match :func:`repro_torch.api.setup`.
    ``device`` fills only the default options, as in :func:`~repro_torch.
    spectral.lobpcg.lobpcg`.
    """
    from repro_torch.api import setup
    from repro_torch.spectral.lobpcg import _default_options

    n = problem.n
    if n_probes is None:
        n_probes = max(1, math.ceil(8.0 * math.log(max(n, 2)) / eps ** 2))
    if options is None:
        options = _default_options(n, device)
    solver = setup(problem, options, backend=backend, mesh=mesh, cache=cache)
    B = _incidence_rhs(problem, n_probes, seed)
    Z, res = solver.solve(B.astype(np.float32), tol=tol, max_iters=max_iters)
    return ResistanceSketch(Z=np.asarray(Z, np.float64),
                            n_probes=n_probes, eps=eps,
                            solve_iters=int(res.iters),
                            backend=solver.backend)


def exact_effective_resistance(problem) -> np.ndarray:
    """Dense (n, n) matrix of exact pairwise resistances (test oracle).

    O(n³) via the pseudo-inverse — only for small validation graphs.
    """
    n = problem.n
    L = np.zeros((n, n), np.float64)
    L[problem.rows, problem.cols] = -np.asarray(problem.vals, np.float64)
    np.fill_diagonal(L, np.asarray(problem.degrees(), np.float64))
    Li = np.linalg.pinv(L, hermitian=True)
    d = np.diag(Li)
    return d[:, None] + d[None, :] - 2.0 * Li
