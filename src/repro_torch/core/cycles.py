"""Multigrid cycles over a built hierarchy (paper §3: V(2,2)-cycle; torch
port of ``repro.core.cycles``). W- and K-cycles are kept as in the
reference. Every per-level matvec goes through the
``repro_torch.sparse.matvec`` dispatch, so levels with an ELL twin run the
``spmv_ell``/``jacobi`` kernels."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import torch

from repro_torch.core.coarsen import AggregationLevel
from repro_torch.core.elimination import EliminationLevel
from repro_torch.core.graph import GraphLevel
from repro_torch.core.smoothers import SmootherConfig, chebyshev, jacobi

Transfer = Union[EliminationLevel, AggregationLevel]


@dataclasses.dataclass(frozen=True)
class CycleConfig:
    kind: str = "V"               # "V" | "W" | "K"
    smoother: SmootherConfig = SmootherConfig()
    k_cycle_steps: int = 2


def _smooth(level: GraphLevel, b, x, sweeps: int, cfg: SmootherConfig,
            lam_max):
    if sweeps == 0:
        return x
    if cfg.kind == "chebyshev":
        return chebyshev(level, b, x, lam_max,
                         degree=cfg.cheby_degree * sweeps // 2
                         if sweeps > 1 else cfg.cheby_degree)
    return jacobi(level, b, x, n_sweeps=sweeps, omega=cfg.omega)


def coarse_solve(coarse_inv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense bottom solve via the precomputed (L + α·J)⁻¹; result mean-free
    (each column of a block ``b`` [n, k]: one product for all k).

    On the card the product runs in float32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
    the entry scripts set it so explicitly, and a caller who turns TF32 on
    gets a less accurate bottom solve."""
    x = coarse_inv @ b
    return x - _mean(x)


def cycle(transfers: Sequence[Transfer], lam_maxes, coarse_inv: torch.Tensor,
          b: torch.Tensor, cfg: CycleConfig, k: int = 0) -> torch.Tensor:
    """Apply one multigrid cycle to L_k x = b (x0 = 0). Returns x_k. ``b``
    is a vector or an ``[n, k]`` block: a block runs every level operation
    once for all k columns (the reference's cycle under ``jax.vmap``), with
    means and dots per column."""
    if k == len(transfers):
        return coarse_solve(coarse_inv, b)

    t = transfers[k]
    if isinstance(t, EliminationLevel):
        b_c = t.restrict(b)
        x_c = cycle(transfers, lam_maxes, coarse_inv, b_c, cfg, k + 1)
        return t.prolong(x_c, b)

    level = t.fine
    sm = cfg.smoother
    x = torch.zeros_like(b)
    x = _smooth(level, b, x, sm.pre_sweeps, sm, lam_maxes[k])
    r = b - level.laplacian_matvec(x)
    r_c = t.restrict(r)
    r_c = r_c - _mean(r_c)

    n_recurse = 1 if cfg.kind == "V" or k + 1 >= len(transfers) else 2
    if cfg.kind == "K" and k + 1 < len(transfers):
        x_c = _fcg_accelerated(transfers, lam_maxes, coarse_inv, r_c, cfg,
                               k + 1)
    else:
        x_c = cycle(transfers, lam_maxes, coarse_inv, r_c, cfg, k + 1)
        for _ in range(n_recurse - 1):
            r2 = r_c - t.coarse.laplacian_matvec(x_c)
            x_c = x_c + cycle(transfers, lam_maxes, coarse_inv, r2, cfg,
                              k + 1)

    x = x + t.prolong(x_c)
    return _smooth(level, b, x, sm.post_sweeps, sm, lam_maxes[k])


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a vector, or of each column of a block ([k])."""
    return x.mean() if x.dim() == 1 else x.mean(dim=0)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u·v of vectors, or of each column pair of blocks ([k])."""
    return torch.dot(u, v) if u.dim() == 1 else (u * v).sum(dim=0)


def _fcg_accelerated(transfers, lam_maxes, coarse_inv, b, cfg: CycleConfig,
                     k: int):
    """K-cycle inner acceleration: ``k_cycle_steps`` of flexible CG whose
    preconditioner is the (k+1)-level cycle."""
    level = transfers[k].fine if k < len(transfers) else None
    matvec = level.laplacian_matvec if level is not None else (lambda v: v)
    x = torch.zeros_like(b)
    r = b
    d_prev = None
    for _ in range(cfg.k_cycle_steps):
        z = cycle(transfers, lam_maxes, coarse_inv, r, cfg, k)
        d = z
        if d_prev is not None:
            Ad_prev = matvec(d_prev)
            beta = _dot(z, Ad_prev) / torch.clamp(_dot(d_prev, Ad_prev),
                                                  min=1e-30)
            d = z - beta * d_prev
        Ad = matvec(d)
        alpha = _dot(r, d) / torch.clamp(_dot(d, Ad), min=1e-30)
        x = x + alpha * d
        r = r - alpha * Ad
        d_prev = d
    return x
