"""Admission-time conditioning triage (torch port of ``repro.api.triage``;
host numpy, as in the reference).

The degradation ladder is reactive: the multigrid path must
*break* before the facade reaches for a cheaper rung. At scale that is
wasted work — a request whose graph is numerically hopeless for the
float32 multigrid path (weight dynamic range beyond what float32 can
even represent across a V-cycle, condition estimates past the attainable
accuracy) burns a full setup + breakdown + rebuild before landing where
triage could have sent it immediately. LAMG (arXiv:1108.0123) picks
methods from conditioning measures at setup time; Sachdeva–Zhao
(arXiv:2304.14345) motivates structurally different cheap fallbacks.
This module is the admission-side version of both ideas: a **cheap,
host-side sanity score** computed once per problem —

* degree extremes (max/min positive weighted degree),
* weight dynamic range (max/min nonzero |w|),
* connected component count,
* a few float64 Lanczos iterations for λ-extreme estimates
  (:func:`lanczos_extremes` — O(k·m), k≈8, deterministic),

— mapped to a **starting ladder rung** and a **guard strictness** before
the first breakdown:

==================  ========================================================
``multigrid``       healthy: the normal path with the options' guards
``multigrid_strict`` suspicious conditioning: multigrid, but with a halved
                    stagnation window so a doomed solve is cut short early
``diag_pcg``        conditioning beyond multigrid's float32 reach and the
                    graph too large for dense: diagonal-PCG rung directly
``dense``           conditioning beyond iterative reach and
                    ``n <= dense_fallback_max``: float64 direct solve
==================  ========================================================

Opt-in via ``SolverOptions(triage=True)``. The report is recorded in
``SolveResult.diagnostics``.
The expensive part of the score (the Lanczos sweep) is memoized on the
``Problem``, so admission triage of the same problem under different
options re-derives only the rung decision.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.krylov import GuardConfig

RUNG_MULTIGRID = "multigrid"
RUNG_MULTIGRID_STRICT = "multigrid_strict"
RUNG_DIAG_PCG = "diag_pcg"
RUNG_DENSE = "dense"

RUNGS = (RUNG_MULTIGRID, RUNG_MULTIGRID_STRICT, RUNG_DIAG_PCG, RUNG_DENSE)

# Conditioning thresholds. Deliberately generous: the reference's
# robustness suite shows the float32 multigrid path absorbs 1e12 weight
# ranges, so
# triage only routes away when the score is far beyond that — a false
# "route away" on a workable graph costs more than it saves.
_STRICT_RANGE = 1e8       # weight range / cond-hat that tightens guards
_HOPELESS_RANGE = 1e14    # weight range beyond float32's iterative reach
_HOPELESS_COND = 1e12     # λmax/λsmall estimate beyond attainable accuracy


@dataclasses.dataclass(frozen=True)
class TriageReport:
    """Admission decision for one problem under one options set.

    ``rung`` — the starting ladder rung; ``guard`` — a tightened
    :class:`GuardConfig` when triage asks for stricter-than-options
    guards, None to keep the options default; ``score`` — the raw
    indicator dict the decision was derived from (JSON-friendly floats).
    """

    rung: str
    guard: GuardConfig | None
    score: dict

    def as_diagnostics(self) -> dict:
        """The ``SolveResult.diagnostics`` entry shape for this report."""
        return dict(stage="triage", status=self.rung, statuses=[],
                    recovered=True, rung=self.rung, score=dict(self.score),
                    strict_guard=self.guard is not None)


def lanczos_extremes(problem, k: int = 8, seed: int = 0
                     ) -> tuple[float, float]:
    """(λmax, λsmall) Ritz estimates of the Laplacian, float64 host math.

    ``k`` Lanczos iterations with full reorthogonalisation against the
    kept basis, started from a seeded mean-free random vector — O(k·m)
    and deterministic. λmax comes out sharp within a few percent; λsmall
    (the smallest positive Ritz value) is a crude upper bound on λ₂, good
    enough for an order-of-magnitude condition estimate — triage
    thresholds are decades apart, not percent apart.
    """
    n = problem.n
    rows = np.asarray(problem.rows)
    cols = np.asarray(problem.cols)
    vals = np.asarray(problem.vals, np.float64)
    deg = np.zeros(n, np.float64)
    np.add.at(deg, rows, vals)

    def mv(x):
        y = deg * x
        np.add.at(y, rows, -vals * x[cols])
        return y

    rng = np.random.default_rng(seed)
    q = rng.normal(size=n)
    q -= q.mean()
    nq = np.linalg.norm(q)
    if nq == 0 or not np.isfinite(nq):         # pragma: no cover
        return 0.0, 0.0
    q /= nq
    Q = [q]
    alphas, betas = [], []
    for _ in range(min(k, n - 1) if n > 1 else 1):
        w = mv(Q[-1])
        a = float(Q[-1] @ w)
        alphas.append(a)
        w = w - a * Q[-1]
        if len(Q) > 1:
            w = w - betas[-1] * Q[-2]
        for qi in Q:                            # full reorthogonalisation
            w = w - (qi @ w) * qi
        w = w - w.mean()
        b = float(np.linalg.norm(w))
        if not np.isfinite(b) or b < 1e-300:
            break
        betas.append(b)
        Q.append(w / b)
    if not alphas or not np.all(np.isfinite(alphas)):
        return float("inf"), 0.0
    m = len(alphas)
    T = np.diag(alphas)
    for i, b in enumerate(betas[: m - 1]):
        T[i, i + 1] = T[i + 1, i] = b
    ritz = np.linalg.eigvalsh(T)
    lam_max = float(ritz.max(initial=0.0))
    pos = ritz[ritz > 1e-12 * max(lam_max, 1.0)]
    lam_small = float(pos.min()) if pos.size else 0.0
    return lam_max, lam_small


def triage_score(problem, lanczos_k: int = 8) -> dict:
    """The raw indicator dict (options-independent, memoized on the
    Problem): degree extremes, weight dynamic range, component count and
    the Lanczos λ-estimates."""
    cached = problem.__dict__.get("_triage_score")
    if cached is not None:
        return cached
    w = np.abs(np.asarray(problem.vals, np.float64))
    wnz = w[w > 0]
    weight_range = float(wnz.max() / wnz.min()) if wnz.size else 1.0
    deg = np.asarray(problem.degrees(), np.float64)
    dpos = deg[deg > 0]
    degree_ratio = float(dpos.max() / dpos.min()) if dpos.size else 1.0
    _, n_components = problem.components()
    lam_max, lam_small = lanczos_extremes(problem, k=lanczos_k)
    cond_hat = (float(lam_max / lam_small) if lam_small > 0
                else float("inf") if lam_max > 0 else 1.0)
    score = dict(
        n=int(problem.n), nnz=int(len(problem.rows)),
        weight_range=weight_range, degree_ratio=degree_ratio,
        n_components=int(n_components), isolated_vertices=int((deg == 0).sum()),
        lam_max=lam_max, lam_small=lam_small, cond_hat=cond_hat,
        lanczos_k=int(lanczos_k))
    problem.__dict__["_triage_score"] = score
    return score


def triage_problem(problem, options) -> TriageReport:
    """Score ``problem`` and pick the starting rung + guard strictness.

    The decision is deliberately conservative toward the multigrid path:
    only a score decades beyond its demonstrated float32 envelope routes
    away (see module docstring), and a merely *suspicious* score keeps
    multigrid but halves the stagnation window so a doomed solve is cut
    short before burning the full iteration budget.
    """
    score = triage_score(problem)
    hopeless = (score["weight_range"] > _HOPELESS_RANGE
                or score["cond_hat"] > _HOPELESS_COND)
    suspicious = (score["weight_range"] > _STRICT_RANGE
                  or score["degree_ratio"] > _STRICT_RANGE
                  or score["cond_hat"] > _STRICT_RANGE)
    if hopeless:
        rung = (RUNG_DENSE if problem.n <= options.dense_fallback_max
                else RUNG_DIAG_PCG)
        return TriageReport(rung=rung, guard=None, score=score)
    if suspicious:
        strict = GuardConfig(
            stagnation_window=max(10, options.stagnation_window // 2))
        return TriageReport(rung=RUNG_MULTIGRID_STRICT, guard=strict,
                            score=score)
    return TriageReport(rung=RUNG_MULTIGRID, guard=None, score=score)
