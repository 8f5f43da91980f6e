"""laplacian-solver [paper]: the paper's own workload as a selectable arch;
torch port of ``repro.configs.laplacian_solver``.

Shapes are synthetic stand-ins for the paper's strong-scaling graphs
(§3.2): an R-MAT power-law graph (web-crawl class) and a dense power-law
BA graph (hollywood-2009 class, the paper's headline graph). The
reference's dry-run lowers the distributed fixed-iteration solve step; its
port waits for ``launch/dryrun.py`` and ``DistLaplacianSolver.
build_solve_step`` (ROADMAP A12). The smoke case runs the port's
``LaplacianSolver`` on a 2,000-vertex cut of ``rmat_16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import ArchSpec, register

SHAPES = ("rmat_16", "rmat_18", "hollywood_40k", "grid_160k")
SHAPE_GRAPHS = dict(
    rmat_16=dict(kind="rmat", scale=16, edge_factor=8),
    rmat_18=dict(kind="rmat", scale=18, edge_factor=8),
    hollywood_40k=dict(kind="ba", n=40000, m=50),
    grid_160k=dict(kind="grid", nx=400, ny=400),
)


def _build_graph(shape_name, seed=0):
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected, grid_2d,
                                               rmat)

    g = SHAPE_GRAPHS[shape_name]
    if g["kind"] == "rmat":
        raw = rmat(g["scale"], g["edge_factor"], seed=seed, weighted=True)
    elif g["kind"] == "ba":
        raw = barabasi_albert(g["n"], g["m"], seed=seed, weighted=True)
    else:
        raw = grid_2d(g["nx"], g["ny"], seed=seed)
    return ensure_connected(*raw, seed=seed)


def make_smoke_case(device=None):
    """The reference's smoke case: ``rmat_16`` cut to its first 2,000
    vertices, set up and solved at tol 1e-6 (60 iterations at most) on
    ``device`` (default: the CUDA card); raises unless it converges."""
    def run():
        from repro_torch.core.solver import LaplacianSolver
        from repro_torch.graphs.generators import ensure_connected

        n, rows, cols, vals = _build_graph("rmat_16")
        # reduced: sub-sample to a small graph for the smoke test
        keep = rows < 2000
        keep &= cols < 2000
        n2, r2, c2, v2 = ensure_connected(2000, rows[keep], cols[keep],
                                          vals[keep])
        solver = LaplacianSolver.setup(n2, r2, c2, v2, device=device)
        rng = np.random.default_rng(0)
        b = rng.normal(size=n2).astype(np.float32)
        b -= b.mean()
        x, info = solver.solve(b, tol=1e-6, maxiter=60)
        if not info.converged:
            raise RuntimeError(f"laplacian-solver smoke case: not converged "
                               f"after {info.iters} iterations")
        return dict(loss=torch.tensor(info.residual_norms[-1]),
                    wda=info.wda, iters=info.iters)
    return run


register(ArchSpec(
    arch_id="laplacian-solver", family="solver", shapes=SHAPES,
    make_smoke_case=make_smoke_case, describe=__doc__))
