#!/usr/bin/env python3
"""The paper's Fig 3 on one CUDA card: Work per Digit of Accuracy of the
port's parallel solver, its serial LAMG-style reference and Jacobi-PCG on
the paper's graph classes.

    python benchmarks/port_wda.py [--scale 1.0] [--tol 1e-8] [--seed 0]
                                  [--graphs NAME ...] [--device cuda]
                                  [--out FILE]

The port's counterpart of ``benchmarks/wda_table.py``. For each graph of
``PAPER_FIG3`` (the seeded stand-ins of ``repro_torch.graphs.datasets``
at ``--scale``), with one seeded mean-free right-hand side:

* ours — the facade, ``backend="single"`` (``LaplacianSolver.setup`` with
  ``SetupConfig(matvec_backend="ell")``), PCG + V-cycle, maxiter 300;
* serial_ref — the facade, ``backend="serial_ref"``, maxiter 300;
* Jacobi-PCG — ``jacobi_pcg`` on the graph's Laplacian with its ELL twin
  (its matvecs run ``spmv_ell``), maxiter 4000.

Both facade solvers run with ``verify="cheap"`` and ``fallback=False``:
the float64 host certificate (``core.verify.certify``, ‖b − Lx‖/‖b‖ off
the edge list) judges every result, and a convergence that the
certificate refutes is reported ``"sdc_certificate"``, never
``"converged"``. Jacobi-PCG's result is judged by the same rule. Where
ours or serial_ref misses the certificate's bound, the row also holds
``float32_floor``: the float64 direct solution's residual and that of the
same solution rounded to float32, which says whether any float32 answer
near the solution could meet the bound.

Each row has the three WDAs beside the paper's, iterations, statuses,
setup seconds (the facade's from a validated ``Problem``), solve
milliseconds (host clock around work that ends in a synchronise; the
facade's include its certificate), the three host residuals and each
kernel's launches per solver. Prints one JSON object a graph (``--out``
also writes them as a list), each with the card's name and power limit.
``--device cpu`` runs the same rows on the CPU (the kernels' plain
versions). Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the paper's Fig 3 values (LAMG, ours, PCG), printed for reference: its
# graphs are the full SuiteSparse / SNAP instances, these are stand-ins,
# so the trends are the comparison (ours between LAMG and PCG, PCG
# blowing up on mesh-like graphs)
PAPER_FIG3 = {
    "as-22july06": (1.72, 3.37, 9.21),
    "as-caida": (1.86, 3.15, 10.47),
    "ca-AstroPh": (6.08, 11.23, 13.52),
    "de2010": (13.49, 9.55, 52.98),
    "delaunay_n13": (8.71, 16.60, 41.02),
    "web-NotreDame": (15.07, 77.05, 149.63),
    "coAuthorsCiteseer": (6.46, 19.85, 45.12),
}
# each solver kernel's package and wrapper
KERNELS = {"spmv_ell": ("repro_torch.kernels.spmv_ell", "spmv_ell"),
           "jacobi": ("repro_torch.kernels.jacobi", "jacobi_step"),
           "agg_vote": ("repro_torch.kernels.agg_vote", "vote_reduce")}


def launches() -> dict:
    """Each solver kernel's launch count so far."""
    return {k: getattr(importlib.import_module(f"{mod}.ops"), fn).launches
            for k, (mod, fn) in KERNELS.items()}


def float32_floor(n, r, c, v, b) -> dict:
    """What a float32 answer can reach on one connected graph: the float64
    direct solution of L x = b (grounded at vertex 0, sparse LU with a
    minimum-degree ordering, one refinement step) with its relative
    residual ``f64_residual``, and ``f32_rounded_residual``, the relative
    residual of that solution rounded to float32 after the shift along L's
    nullspace (mean, median or midrange) that rounds best. Both are
    ‖b − Lx‖/‖b‖ in float64."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    a = sp.csr_matrix((np.asarray(v, np.float64), (r, c)), shape=(n, n))
    lap = (sp.diags(np.asarray(a.sum(axis=1)).ravel()) - a).tocsr()
    b = np.asarray(b, np.float64)
    lu = splu(lap[1:, 1:].tocsc(), permc_spec="MMD_AT_PLUS_A")
    x = np.zeros(n)
    x[1:] = lu.solve(b[1:])
    x[1:] += lu.solve((b - lap @ x)[1:])

    def rel(y):
        return float(np.linalg.norm(b - lap @ y) / np.linalg.norm(b))

    shifts = (x.mean(), np.median(x), (x.max() + x.min()) / 2)
    return dict(f64_residual=rel(x), f32_rounded_residual=min(
        rel((x - s).astype(np.float32).astype(np.float64)) for s in shifts))


def fig3_row(torch, name: str, scale: float = 1.0, tol: float = 1e-8,
             seed: int = 0, device: str = "cuda") -> dict:
    """One graph's row: the three solvers in turn on ``device``, each
    freed before the next."""
    import numpy as np

    from repro_torch.api import Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.core import jacobi_pcg
    from repro_torch.core.graph import graph_from_adjacency
    from repro_torch.core.verify import CERT_FLOOR, certify
    from repro_torch.core.wda import wda
    from repro_torch.graphs.datasets import paper_graph
    from repro_torch.graphs.generators import to_laplacian_coo
    from repro_torch.sparse.matvec import build_hybrid

    on_card = torch.device(device).type == "cuda"

    def timed(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def since(before):
        now = launches()
        return {k: now[k] - before[k] for k in now}

    n, r, c, v = paper_graph(name, scale=scale, seed=seed)
    problem = Problem.from_edges(n, r, c, v)
    b = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    b -= b.mean()
    paper = PAPER_FIG3.get(name, (float("nan"),) * 3)
    row = dict(graph=name, n=n, nnz=len(r), paper_lamg=paper[0],
               paper_ours=paper[1], paper_pcg=paper[2])

    opts = SolverOptions(matvec_backend="ell", tol=tol, max_iters=300,
                         verify="cheap", fallback=False, device=device)
    for who, backend in (("ours", "single"), ("serial_ref", "serial_ref")):
        k0 = launches()
        solver, setup_s = timed(lambda: api_setup(problem, opts,
                                                  backend=backend,
                                                  cache=False))
        (_, res), solve_s = timed(lambda: solver.solve(b))
        row[who] = dict(wda=res.wda, iters=res.iters, status=res.status,
                        setup_s=setup_s, solve_ms=solve_s * 1e3,
                        levels=len(solver.stats()["levels"]),
                        host_residual=res.certificate.rel_residuals[0],
                        launches=since(k0))
        del solver

    level = graph_from_adjacency(to_laplacian_coo(n, r, c, v,
                                                  device=device))
    ell, rem = build_hybrid(level.adj, "ell")
    level = dataclasses.replace(level, ell=ell, ell_rem=rem)
    k0 = launches()
    (x, info_j), jac_s = timed(lambda: jacobi_pcg(
        level, torch.as_tensor(b, device=device), tol=tol, maxiter=4000))
    cert = certify(problem, b, x.cpu().numpy(), tol,
                   claimed=[info_j.converged])
    row["jacobi_pcg"] = dict(
        wda=wda(info_j.residual_norms, 1.0), iters=info_j.iters,
        # the facade's rule: a refuted claim is "sdc_certificate"
        status="sdc_certificate" if len(cert.failed_columns())
        else info_j.status,
        solve_ms=jac_s * 1e3, host_residual=cert.rel_residuals[0],
        launches=since(k0))
    del level, x

    row["float32_floor"] = None
    if max(row["ours"]["host_residual"],
           row["serial_ref"]["host_residual"]) > CERT_FLOOR:
        row["float32_floor"] = float32_floor(n, r, c, v, b)
    return row


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graphs", nargs="+", default=list(PAPER_FIG3))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    card = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("port_wda: needs a CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        _build.library()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    rows = []
    for name in args.graphs:
        row = dict(card=card, scale=args.scale, tol=args.tol,
                   **fig3_row(torch, name, args.scale, args.tol, args.seed,
                              args.device))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
