"""Strength-of-connection metrics (paper §2.4; torch port of
``repro.core.strength``).

Algebraic distance (the paper's choice) and LAMG affinity, both from K
damped-Jacobi relaxations of L x = 0 on R random vectors. The start
vectors are the reference's ``jax.random.uniform`` draw, recomputed bit
for bit by ``repro_torch.core.prng``; strengths are per edge, aligned with
``level.adj``, normalised into (0, 1].
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.graph import GraphLevel, count_tensor, pow2_bucket
from repro_torch.core.prng import uniform
from repro_torch.sparse import matvec as matvec_ops
from repro_torch.sparse.segment import take_fill


def relaxed_test_vectors(level: GraphLevel, n_vectors: int = 8,
                         n_sweeps: int = 20, omega: float = 0.5,
                         seed: int = 0, n_valid=None,
                         x0: torch.Tensor | None = None) -> torch.Tensor:
    """[n, R] test vectors: K damped-Jacobi sweeps on L x = 0, with the
    state padded to the power-of-two bucket of ``n`` as in the reference.

    ``n_valid``: the count of real vertices (an int or a 0-d tensor) when
    ``level`` is itself bucket-padded; padding rows stay zero and are left
    out of the mean. ``x0``: the start vectors already drawn, equal to
    ``prng.uniform(seed, (pow2_bucket(n), n_vectors), -0.5, 0.5)`` (the
    super-step setup draws them once per bucket)."""
    n = level.n
    n_pad = pow2_bucket(n)
    dev = level.deg.device
    n_real = count_tensor(n if n_valid is None else n_valid, dev)
    if x0 is None:
        x0 = uniform(seed, (n_pad, n_vectors), -0.5, 0.5, dev)
    row_ok = (torch.arange(n_pad, device=dev) < n_real)[:, None]
    x = torch.where(row_ok, x0, 0.0)
    inv_d = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    inv_d[:n] = 1.0 / torch.clamp(level.deg, min=1e-30)
    ax = torch.zeros_like(x)
    for _ in range(n_sweeps):
        # Jacobi on Lx=0:  x <- (1-ω) x + ω D⁻¹ A x
        ax[:n] = matvec_ops.level_spmm(level, x[:n])
        x = (1 - omega) * x + omega * inv_d[:, None] * ax
        x = x - x.sum(dim=0, keepdim=True) / n_real
        x = torch.where(row_ok, x, 0.0)
        x = x / torch.clamp(x.abs().amax(dim=0, keepdim=True), min=1e-30)
    return x[:n]


def algebraic_distance_strength(level: GraphLevel, n_vectors: int = 8,
                                n_sweeps: int = 20, seed: int = 0,
                                p_norm: float = math.inf, n_valid=None,
                                x0: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Per-edge strength = 1 / algebraic distance (Ron–Safro–Brandt);
    ``n_valid`` and ``x0`` as in :func:`relaxed_test_vectors`."""
    x = relaxed_test_vectors(level, n_vectors, n_sweeps, seed=seed,
                             n_valid=n_valid, x0=x0)
    adj = level.adj
    xi = take_fill(x, adj.row.clamp(max=level.n - 1), 0)
    xj = take_fill(x, adj.col.clamp(max=level.n - 1), 0)
    d = (xi - xj).abs()
    if math.isinf(float(p_norm)):
        dist = d.amax(dim=1)
    else:
        dist = (d ** p_norm).sum(dim=1) ** (1.0 / p_norm)
    strength = 1.0 / (dist + 1e-6)
    top = torch.where(adj.valid, strength, 0.0).amax()
    strength = strength / torch.clamp(top, min=1e-30)
    return torch.where(adj.valid, torch.clamp(strength, min=1e-9), 0.0)


def affinity_strength(level: GraphLevel, n_vectors: int = 8,
                      n_sweeps: int = 20, seed: int = 0, n_valid=None,
                      x0: torch.Tensor | None = None) -> torch.Tensor:
    """LAMG affinity c_uv = |⟨x_u, x_v⟩|² / (⟨x_u,x_u⟩⟨x_v,x_v⟩) per edge;
    ``n_valid`` and ``x0`` as in :func:`relaxed_test_vectors`."""
    x = relaxed_test_vectors(level, n_vectors, n_sweeps, seed=seed,
                             n_valid=n_valid, x0=x0)
    adj = level.adj
    xi = take_fill(x, adj.row.clamp(max=level.n - 1), 0)
    xj = take_fill(x, adj.col.clamp(max=level.n - 1), 1)
    num = (xi * xj).sum(dim=1) ** 2
    den = (xi * xi).sum(dim=1) * (xj * xj).sum(dim=1)
    c = num / torch.clamp(den, min=1e-30)
    return torch.where(adj.valid, torch.clamp(c, 1e-9, 1.0), 0.0)


STRENGTH_METRICS = {
    "algebraic_distance": algebraic_distance_strength,
    "affinity": affinity_strength,
}
