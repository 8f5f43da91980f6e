"""Work per Digit of Accuracy (paper §3.1; torch port of ``repro.core.wda``).

    WDA = (work_per_iteration × iterations) / log10(‖r₀‖ / ‖r_k‖)

with work in finest-level matvec equivalents, counted as in the reference.
"""

from __future__ import annotations

import math

from repro_torch.core.cycles import CycleConfig
from repro_torch.core.elimination import EliminationLevel


def finest_matvec_cost(h) -> float:
    """Cost of one finest-level Laplacian matvec in raw units (nnz + n)."""
    t0 = h.transfers[0]
    return t0.fine.adj.nnz + t0.fine.n


def cycle_work_units(h, cfg: CycleConfig) -> float:
    """Work of ONE multigrid cycle in finest-matvec equivalents."""
    base = h.transfers[0].fine.adj.nnz + h.transfers[0].fine.n
    work = 0.0
    visits = 1.0
    for t in h.transfers:
        if isinstance(t, EliminationLevel):
            work += visits * (2 * t.p_f.nnz + t.fine.n) / base
        else:
            sm = cfg.smoother
            sweeps = sm.pre_sweeps + sm.post_sweeps
            if sm.kind == "chebyshev":
                sweeps = 2 * sm.cheby_degree
            lvl_mv = t.fine.adj.nnz + t.fine.n
            work += visits * ((sweeps + 1) * lvl_mv + 2 * t.fine.n) / base
            if cfg.kind == "K":
                work += visits * cfg.k_cycle_steps * lvl_mv / base
            if cfg.kind in ("W", "K"):
                visits *= 2.0
    n_c = h.coarse_inv.shape[0]
    work += visits * (n_c * n_c) / base
    return work


def pcg_iteration_work(h, cfg: CycleConfig) -> float:
    """Work of one PCG iteration preconditioned by the cycle."""
    return 1.0 + cycle_work_units(h, cfg)


def wda(residual_norms, work_per_iteration: float) -> float:
    """Work per digit of accuracy from a residual history."""
    r0, rk = residual_norms[0], residual_norms[-1]
    iters = len(residual_norms) - 1
    if rk <= 0 or r0 <= 0 or iters == 0:
        return float("inf")
    digits = math.log10(r0 / rk)
    if digits <= 0:
        return float("inf")
    return work_per_iteration * iters / digits
