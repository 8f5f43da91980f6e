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
from repro_torch.sparse.segment import take_fill, take_groups


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


# ----------------------------------------------------------------------------
# Group forms (the batched setup): G bucket-padded levels of one bucket
# (``core.graph.GroupLevel``), ``n_valid`` a [G] tensor, the bucket's one
# draw ``x0`` shared by every graph. Graph g's strengths are bit for bit its
# own level's: the sweeps are elementwise, row-wise or exact (the maxima),
# and the column sum a sweep takes for its mean runs a graph at a time,
# since a reduction of ``[G, n, R]`` along n need not add in the order of
# ``[n, R]`` along 0.
# ----------------------------------------------------------------------------

def _column_sums(x: torch.Tensor) -> torch.Tensor:
    """``x[g].sum(dim=0, keepdim=True)`` of every graph g, stacked: each
    graph's sums add in the order of its own build's."""
    return torch.stack([x[g].sum(dim=0, keepdim=True)
                        for g in range(x.shape[0])])


def relaxed_test_vectors_groups(level, n_vectors: int = 8,
                                n_sweeps: int = 20, omega: float = 0.5,
                                seed: int = 0, n_valid=None,
                                x0: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """:func:`relaxed_test_vectors` of every graph of a group: ``[G, n,
    R]``, the bucket's ``x0`` ``[n, R]`` broadcast, not copied."""
    n = level.n
    dev = level.deg.device
    n_real = n_valid
    if x0 is None:
        x0 = uniform(seed, (n, n_vectors), -0.5, 0.5, dev)
    row_ok = (torch.arange(n, device=dev) < n_real[:, None])[..., None]
    x = torch.where(row_ok, x0, 0.0)
    inv_d = 1.0 / torch.clamp(level.deg, min=1e-30)
    for _ in range(n_sweeps):
        ax = matvec_ops.level_spmv_groups(level, x)
        x = (1 - omega) * x + omega * inv_d[..., None] * ax
        x = x - _column_sums(x) / n_real[:, None, None]
        x = torch.where(row_ok, x, 0.0)
        x = x / torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-30)
    return x


def _row_sums(t: torch.Tensor) -> torch.Tensor:
    # the [m, R] row sums a graph at a time, in its own build's order
    return torch.stack([t[g].sum(dim=1) for g in range(t.shape[0])])


def algebraic_distance_strength_groups(level, n_vectors: int = 8,
                                       n_sweeps: int = 20, seed: int = 0,
                                       p_norm: float = math.inf,
                                       n_valid=None,
                                       x0: torch.Tensor | None = None
                                       ) -> torch.Tensor:
    """:func:`algebraic_distance_strength` of every graph of a group,
    ``[G, e_cap]``."""
    x = relaxed_test_vectors_groups(level, n_vectors, n_sweeps, seed=seed,
                                    n_valid=n_valid, x0=x0)
    n = level.n
    xi = take_groups(x, level.row.clamp(max=n - 1), 0)
    xj = take_groups(x, level.col.clamp(max=n - 1), 0)
    d = (xi - xj).abs()
    if math.isinf(float(p_norm)):
        dist = d.amax(dim=2)
    else:
        dist = _row_sums(d ** p_norm) ** (1.0 / p_norm)
    strength = 1.0 / (dist + 1e-6)
    valid = level.valid
    top = torch.where(valid, strength, 0.0).amax(dim=1, keepdim=True)
    strength = strength / torch.clamp(top, min=1e-30)
    return torch.where(valid, torch.clamp(strength, min=1e-9), 0.0)


def affinity_strength_groups(level, n_vectors: int = 8, n_sweeps: int = 20,
                             seed: int = 0, n_valid=None,
                             x0: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`affinity_strength` of every graph of a group, ``[G,
    e_cap]``."""
    x = relaxed_test_vectors_groups(level, n_vectors, n_sweeps, seed=seed,
                                    n_valid=n_valid, x0=x0)
    n = level.n
    xi = take_groups(x, level.row.clamp(max=n - 1), 0)
    xj = take_groups(x, level.col.clamp(max=n - 1), 1)
    num = _row_sums(xi * xj) ** 2
    den = _row_sums(xi * xi) * _row_sums(xj * xj)
    c = num / torch.clamp(den, min=1e-30)
    return torch.where(level.valid, torch.clamp(c, 1e-9, 1.0), 0.0)


STRENGTH_METRICS_GROUPS = {
    "algebraic_distance": algebraic_distance_strength_groups,
    "affinity": affinity_strength_groups,
}
