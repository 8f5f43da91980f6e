"""ABFT checksums and residual certification for self-verifying solves
(torch port of ``repro.core.verify``).

**In-flight checksum** (:func:`make_check`). A graph Laplacian has zero
column sums, so ``1ᵀ(Lp) = 0``; the hot path computes ``Lp`` as
``deg·p − A·p``, so the identity couples the stored degree vector with the
executed adjacency SpMV. The cheap check evaluates, per column,

    ``|Σᵢ (Ap)ᵢ|  ≤  rtol · Σᵢ degᵢ |pᵢ|``

with a few O(nk) reductions on the solver's device. ``mode="paranoid"``
adds a witness: a fixed seeded Rademacher vector ``w`` with ``u = Lw``
computed once when the check is built, and symmetry gives ``wᵀ(Lp) =
uᵀp``. The checks are NaN-safe (a non-finite delta flags) and only
observe: clean solves are bitwise the same with verification on or off.

**Residual certificate** (:func:`certify`). After the solve, the projected
relative residual ``‖proj(b − Lx)‖ / ‖proj b‖`` is recomputed on the host
in float64 straight from the Problem's edge list, sharing no code or
setup artifact with the hot path. The float64 sums are ``np.bincount``
weighted histograms, which add each row's terms in edge-list order as
the reference's ``np.add.at`` does, so the certificate's residuals equal
the reference's, at a fraction of ``np.add.at``'s cost.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# float64 certification floor: a float32 solve that honestly converged to
# tol can still show an O(eps32 · cond) true residual in float64, so
# certify against max(tol, CERT_FLOOR)
CERT_FLOOR = 1e-4

# checksum relative tolerance: ~20x over the float32 cancellation noise of
# the column-sum identity, far below the weakest covered corruption
CHECK_RTOL = 3e-4


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """Checksum policy: ``mode`` is ``"cheap"`` (zero-column-sum identity)
    or ``"paranoid"`` (adds the Rademacher witness); ``rtol`` the relative
    mismatch threshold; ``seed`` seeds the witness vector."""

    mode: str = "cheap"
    rtol: float = CHECK_RTOL
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("cheap", "paranoid"):
            raise ValueError(f"verify mode must be 'cheap' or 'paranoid', "
                             f"got {self.mode!r}")


def make_check(deg, cfg: VerifyConfig, matvec=None):
    """Build ``check(P, Ap) -> bool[k]`` for a Laplacian with degrees ``deg``.

    ``P``/``Ap`` may be ``(n,)`` or ``(n, k)`` tensors on ``deg``'s device;
    the result is a boolean tensor per column (True = mismatch, suspected
    SDC), computed there without a host read. ``deg`` must be in the
    order of the vectors the solver iterates on. For ``mode="paranoid"``
    pass the clean setup-time ``matvec``: ``u = L w`` is evaluated once,
    here.
    """
    deg = torch.as_tensor(deg)
    rtol = float(cfg.rtol)
    tiny = float(np.finfo(np.float32).tiny)
    w = u = None
    if cfg.mode == "paranoid":
        if matvec is None:
            raise ValueError("paranoid verification needs the setup-time "
                             "matvec to precompute its witness u = L w")
        rng = np.random.default_rng((cfg.seed, deg.shape[0]))
        w_host = rng.choice((-1.0, 1.0), deg.shape[0]).astype(np.float32)
        w = torch.as_tensor(w_host, device=deg.device)
        u = matvec(w)

    def check(P, Ap):
        expand = (lambda v: v) if P.dim() == 1 else (lambda v: v[:, None])
        scale = (expand(deg) * P.abs()).sum(dim=0) + tiny
        # NaN-safe: a non-finite column sum fails the <= and flags bad
        bad = ~(Ap.sum(dim=0).abs() <= rtol * scale)
        if w is not None:
            s2 = ((expand(w).abs() * Ap.abs()).sum(dim=0)
                  + (expand(u).abs() * P.abs()).sum(dim=0) + tiny)
            d2 = ((expand(w) * Ap).sum(dim=0)
                  - (expand(u) * P).sum(dim=0)).abs()
            bad = bad | ~(d2 <= rtol * s2)
        return bad

    return check


@dataclasses.dataclass(frozen=True)
class Certificate:
    """A-posteriori residual certificate attached to ``SolveResult``.

    * ``method`` — how the check was computed (``"host_float64"``).
    * ``passed`` — every column that *claimed* convergence has
      ``rel_residual <= threshold``.
    * ``threshold`` — ``max(tol, CERT_FLOOR)``.
    * ``rel_residuals`` — per-column ``‖proj(b − Lx)‖ / ‖proj b‖`` in
      float64, for all columns.
    * ``claimed`` — the per-column claimed-converged mask.
    """

    method: str
    passed: bool
    threshold: float
    rel_residuals: tuple
    claimed: tuple

    def failed_columns(self) -> np.ndarray:
        """Indices of columns that claimed convergence but failed."""
        rel = np.asarray(self.rel_residuals, np.float64)
        claimed = np.asarray(self.claimed, bool)
        with np.errstate(invalid="ignore"):
            ok = rel <= self.threshold
        return np.nonzero(claimed & ~ok)[0]


def _segsum(ids, V, n_out: int) -> np.ndarray:
    """Per-column ``out[ids[i]] += V[i]`` in float64, in entry order."""
    return np.stack([np.bincount(ids, weights=V[:, j], minlength=n_out)
                     for j in range(V.shape[1])], axis=1)


def certify(problem, B, X, tol, claimed=None) -> Certificate:
    """Certify ``X`` against ``L X = proj B`` via an independent float64
    host SpMV off ``problem``'s edge list (both directions stored) and
    component labels. ``claimed`` is the per-column claimed-converged mask
    (default: all columns)."""
    rows = np.asarray(problem.rows)
    cols = np.asarray(problem.cols)
    vals = np.asarray(problem.vals, np.float64)
    n = problem.n
    B = np.asarray(B, np.float64)
    X = np.asarray(X, np.float64)
    if B.ndim == 1:
        B = B[:, None]
    if X.ndim == 1:
        X = X[:, None]
    k = B.shape[1]

    deg = np.bincount(rows, weights=vals, minlength=n)
    # L x = deg·x − A x, accumulated entirely on host in float64
    AX = np.stack([np.bincount(rows, weights=vals * X[cols, j], minlength=n)
                   for j in range(k)], axis=1)
    R = B - (deg[:, None] * X - AX)

    comp, n_comp = problem.components()
    counts = np.bincount(comp, minlength=n_comp).astype(np.float64)

    def proj(V):
        return V - (_segsum(comp, V, n_comp) / counts[:, None])[comp]

    ref = np.linalg.norm(proj(B), axis=0)
    res = np.linalg.norm(proj(R), axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.where(ref > 0, res / ref, res)
    threshold = max(float(np.max(np.asarray(tol))), CERT_FLOOR)
    claimed_arr = (np.ones(k, bool) if claimed is None
                   else np.asarray(claimed, bool).reshape(k))
    with np.errstate(invalid="ignore"):
        ok = rel <= threshold
    passed = bool(np.all(ok[claimed_arr])) if claimed_arr.any() else True
    return Certificate(method="host_float64", passed=passed,
                       threshold=threshold,
                       rel_residuals=tuple(float(r) for r in rel),
                       claimed=tuple(bool(c) for c in claimed_arr))
