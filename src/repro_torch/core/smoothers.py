"""Smoothers (paper §2.5; torch port of ``repro.core.smoothers``).

* ``jacobi``    — weighted Jacobi, the paper's smoother (ω = 2/3); on a
  level with an ELL twin each sweep is one fused ``jacobi`` kernel launch.
* ``chebyshev`` — Chebyshev smoothing over [λmax/4, λmax] of D⁻¹L.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import GraphLevel, count_tensor, pow2_bucket
from repro_torch.core.prng import normal
from repro_torch.sparse.coo import spmv
from repro_torch.sparse.segment import per_row


def jacobi(level: GraphLevel, b: torch.Tensor, x: torch.Tensor,
           n_sweeps: int = 2, omega: float = 2.0 / 3.0) -> torch.Tensor:
    """x ← x + ω D⁻¹ (b − L x), ``n_sweeps`` times; ``b`` and ``x`` vectors
    or ``[n, k]`` blocks (each column swept as the vector would be)."""
    if getattr(level, "ell", None) is not None:
        return _jacobi_ell(level, b, x, n_sweeps, omega)
    inv_d = per_row(1.0 / torch.clamp(level.deg, min=1e-30), x)
    for _ in range(n_sweeps):
        r = b - level.laplacian_matvec(x)
        x = x + omega * inv_d * r
    return x


def _jacobi_ell(level, b: torch.Tensor, x: torch.Tensor, n_sweeps: int,
                omega: float) -> torch.Tensor:
    """Fused hybrid sweeps: x' = x + ω D⁻¹ ((b + A_rem x) − (D x − A_ell x)).
    The spill edges fold into the right-hand side first (once a sweep for
    all columns of a block), so the fused sweep stays exact on levels
    whose rows overflow the ELL width; a block runs the k-column kernel."""
    from repro_torch.kernels.jacobi import jacobi_step

    ell, rem = level.ell, level.ell_rem
    for _ in range(n_sweeps):
        b_eff = b if rem is None else b + spmv(rem, x)
        x = jacobi_step(ell.col, ell.val, x, b_eff, level.deg, omega=omega)
    return x


def estimate_lambda_max(level: GraphLevel, n_iters: int = 15,
                        seed: int = 0, n_valid=None,
                        v0: torch.Tensor | None = None) -> torch.Tensor:
    """Power iteration on D⁻¹L (setup time). The iteration state is padded
    to the power-of-two bucket of ``n``, as in the reference, and starts
    from the reference's ``jax.random.normal`` draw.

    ``n_valid``: the count of real vertices (an int or a 0-d tensor) when
    ``level`` is itself bucket-padded. ``v0``: the start vector already
    drawn, equal to ``prng.normal(seed, (pow2_bucket(n),))`` (the
    super-step setup draws it once per bucket)."""
    n = level.n
    n_pad = pow2_bucket(n)
    dev = level.deg.device
    n_real = count_tensor(n if n_valid is None else n_valid, dev)
    row_ok = torch.arange(n_pad, device=dev) < n_real
    inv_d = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    inv_d[:n] = 1.0 / torch.clamp(level.deg, min=1e-30)
    if v0 is None:
        v0 = normal(seed, (n_pad,), dev)
    v = torch.where(row_ok, v0, 0.0)
    v = torch.where(row_ok, v - v.sum() / n_real, 0.0)
    v = v / torch.linalg.norm(v)
    lam = torch.zeros((), device=dev)
    for _ in range(n_iters):
        w = torch.zeros_like(v)
        w[:n] = inv_d[:n] * level.laplacian_matvec(v[:n])
        w = torch.where(row_ok, w - w.sum() / n_real, 0.0)
        lam = torch.linalg.norm(w)
        v = w / torch.clamp(lam, min=1e-30)
    return lam * 1.05


def _member_sums(v: torch.Tensor) -> torch.Tensor:
    # each graph's sum alone: in its own build's order
    return torch.stack([v[g].sum() for g in range(v.shape[0])])


def _member_norms(v: torch.Tensor) -> torch.Tensor:
    # each graph's 2-norm alone: in its own build's order
    return torch.stack([torch.linalg.norm(v[g]) for g in range(v.shape[0])])


def estimate_lambda_max_groups(level, n_iters: int = 15, seed: int = 0,
                               n_valid=None,
                               v0: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """:func:`estimate_lambda_max` of every graph of a group
    (``core.graph.GroupLevel``, ``n_valid`` a [G] tensor): ``[G]``, graph
    g's bit for bit its own level's. The bucket's start vector ``v0`` is
    broadcast, not copied; the sums and norms run a graph at a time (a
    reduction of ``[G, n]`` along n need not add in the order of
    ``[n]``)."""
    n = level.n
    dev = level.deg.device
    n_real = n_valid
    row_ok = torch.arange(n, device=dev) < n_real[:, None]
    inv_d = 1.0 / torch.clamp(level.deg, min=1e-30)
    if v0 is None:
        v0 = normal(seed, (n,), dev)
    v = torch.where(row_ok, v0, 0.0)
    v = torch.where(row_ok, v - (_member_sums(v) / n_real)[:, None], 0.0)
    v = v / _member_norms(v)[:, None]
    lam = torch.zeros(level.groups, device=dev)
    for _ in range(n_iters):
        w = inv_d * level.laplacian_matvec(v)
        w = torch.where(row_ok, w - (_member_sums(w) / n_real)[:, None],
                        0.0)
        lam = _member_norms(w)
        v = w / torch.clamp(lam, min=1e-30)[:, None]
    return lam * 1.05


def chebyshev(level: GraphLevel, b: torch.Tensor, x: torch.Tensor,
              lam_max: torch.Tensor, degree: int = 3,
              lam_min_frac: float = 0.25) -> torch.Tensor:
    """Chebyshev smoothing on D⁻¹L over [λmax/4, λmax]; ``b`` and ``x``
    vectors or ``[n, k]`` blocks (λmax is the level's, shared by every
    column, as under the reference's vmap)."""
    inv_d = per_row(1.0 / torch.clamp(level.deg, min=1e-30), x)
    lmin = lam_max * lam_min_frac
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)

    r = b - level.laplacian_matvec(x)
    d = inv_d * r / theta
    x = x + d
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = b - level.laplacian_matvec(x)
        d = rho_new * rho * d + 2.0 * rho_new / delta * (inv_d * r)
        x = x + d
        rho = rho_new
    return x


@dataclasses.dataclass(frozen=True)
class SmootherConfig:
    kind: str = "jacobi"          # "jacobi" | "chebyshev"
    pre_sweeps: int = 2
    post_sweeps: int = 2
    omega: float = 2.0 / 3.0
    cheby_degree: int = 3
