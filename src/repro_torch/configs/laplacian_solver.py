"""laplacian-solver [paper]: the paper's own workload as a selectable arch;
torch port of ``repro.configs.laplacian_solver``.

Shapes are synthetic stand-ins for the paper's strong-scaling graphs
(§3.2): an R-MAT power-law graph (web-crawl class) and a dense power-law
BA graph (hollywood-2009 class, the paper's headline graph). The dry-run
builds a REAL multigrid hierarchy on the device (setup phase),
partitions its top levels 2D over the mesh, and runs rank 0's
fixed-iteration PCG+V-cycle ``solve_step`` for real over the mesh's fake
group, which counts every all-reduce of the solve phase. The smoke case
runs the port's ``LaplacianSolver`` on a 2,000-vertex cut of ``rmat_16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import (ArchSpec, DryrunCase, TensorSpec,
                                          register)

SHAPES = ("rmat_16", "rmat_18", "hollywood_40k", "grid_160k")
SHAPE_GRAPHS = dict(
    rmat_16=dict(kind="rmat", scale=16, edge_factor=8),
    rmat_18=dict(kind="rmat", scale=18, edge_factor=8),
    hollywood_40k=dict(kind="ba", n=40000, m=50),
    grid_160k=dict(kind="grid", nx=400, ny=400),
)
N_ITERS = 20


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


def make_dryrun_case(shape_name, mesh):
    """The reference's solver dry-run case on the geometry of ``mesh`` (a
    ``DeviceMesh`` over the fake world): :func:`solve_case` on the shape's
    graph with the reference's setup (coarsest 128, levels of 50,000 and
    more edges distributed, at most 3)."""
    from repro_torch.core.hierarchy import SetupConfig

    return solve_case(f"laplacian-solver/{shape_name}",
                      _build_graph(shape_name), mesh,
                      SetupConfig(coarsest_size=128),
                      dist_nnz_threshold=50_000, max_dist_levels=3)


def solve_case(name, graph, mesh, setup_config, dist_nnz_threshold: int,
               max_dist_levels: int, n_iters: int = N_ITERS):
    """A solver dry-run case for ``graph`` ``(n, rows, cols, vals)``: a
    ``ProcessMesh`` of ``mesh``'s shape over the default group (this
    process its rank, on the mesh's device type), the hierarchy built by
    the eager setup (no collectives, which on a fake world would move
    nothing and give a wrong hierarchy; the same hierarchy as the
    super-step's), this rank's blocks of its top levels, and
    ``build_solve_step(n_iters)`` at tol 0, so that the values a fake
    world's all-reduces leave cannot end it early. The step runs on real
    tensors (``fake=False``) and the mesh's ``stats()`` count its
    all-reduces."""
    import dataclasses as dc

    from repro_torch.dist.solver import DistLaplacianSolver
    from repro_torch.launch.mesh import process_mesh_of

    pmesh = process_mesh_of(mesh)
    n, rows, cols, vals = graph
    solver = DistLaplacianSolver.setup(
        n, rows, cols, vals, pmesh,
        dc.replace(setup_config, setup_mode="eager"),
        dist_nnz_threshold=dist_nnz_threshold,
        max_dist_levels=max_dist_levels)
    step = solver.build_solve_step(n_iters=n_iters)
    nnz = int(len(rows))  # rows already holds both edge directions
    b_spec = TensorSpec((solver.n_pad,), torch.float32)

    def make_inputs(args, fake_mode=None):
        rng = np.random.default_rng(0)
        b = np.zeros(solver.n_pad, np.float32)
        b[:n] = rng.normal(size=n)
        b[:n] -= b[:n].mean()
        return (solver.arrays, solver.coarse_h,
                torch.as_tensor(b, device=pmesh.device))

    return DryrunCase(
        name=name, fn=step,
        build_args=lambda: (solver.arrays, solver.coarse_h, b_spec),
        in_placements=None, out_placements=None,
        model_flops=2.0 * nnz * 12.0 * n_iters,   # ≈ work/iter × matvec cost
        comment=f"PCG({n_iters}) + V(2,2) on n={n} nnz={nnz}; "
                f"{len(solver.level_meta)} distributed level(s), "
                f"{solver.coarse_h.n_levels} replicated",
        make_inputs=make_inputs, fake=False, process_mesh=pmesh)


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
    make_dryrun_case=make_dryrun_case,
    make_smoke_case=make_smoke_case, describe=__doc__))
