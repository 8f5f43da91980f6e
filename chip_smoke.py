#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each (any failure exits non-zero):

1. build   — compile the three kernels of ``src/repro_torch/csrc`` for
             sm_90a with nvcc; print the seconds and the card's name and
             power limit as nvidia-smi reports them.
2. main    — the paper's solver at the per-process scale of its largest
             run: Barabási–Albert n = 2^20, m = 4 (about 4.2 M undirected
             edges), ``LaplacianSolver.setup(SetupConfig(matvec_backend=
             "ell"))`` and four seeded mean-free solves at tol 1e-6. Every
             solve must converge and pass a float64 host residual
             certificate (‖b − Lx‖/‖b‖ ≤ 1e-4); a repeated solve must be
             bitwise equal; each kernel's launch count, reset to 0 just
             before and read just after, must be above 0.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (spmv_ell and jacobi at rtol 1e-5 /
             atol 1e-6, agg_vote bit-exact), with its time, the plain
             version's, its bound, and for spmv_ell a
             ``torch.sparse_csr_tensor`` product as a yardstick.
4. e2e     — the same path at n = 2^16 with the kernels and with the plain
             versions: identical levels, iteration counts within ±1 and
             ‖x_k − x_p‖/‖x_p‖ ≤ 1e-4.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
MAIN_N, E2E_N = 1 << 20, 1 << 16
REPLACES = {
    "spmv_ell": "src/repro/kernels/spmv_ell/spmv_ell.py:41",
    "jacobi": "src/repro/kernels/jacobi/jacobi.py:35",
    "agg_vote": "src/repro/kernels/agg_vote/agg_vote.py:51",
}
# each kernel package's wrapper and its plain version
WRAPPERS = {
    "repro_torch.kernels.spmv_ell": ("spmv_ell", "spmv_ell_ref"),
    "repro_torch.kernels.jacobi": ("jacobi_step", "jacobi_step_ref"),
    "repro_torch.kernels.agg_vote": ("vote_reduce", "vote_reduce_ref"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_versions():
    """Rebind each kernel package's wrapper to its plain version for the
    duration of the block. The port's modules import the wrappers at call
    time, so the whole path then runs the plain versions, on the card too.
    This is a check of the kernels only; the port itself has no such
    switch."""
    saved = {}
    for mod_name, (wrapper, ref) in WRAPPERS.items():
        mod = importlib.import_module(mod_name)
        saved[mod_name] = getattr(mod, wrapper)
        setattr(mod, wrapper, getattr(mod, ref))
    try:
        yield
    finally:
        for mod_name, (wrapper, _) in WRAPPERS.items():
            setattr(importlib.import_module(mod_name), wrapper,
                    saved[mod_name])


def launch_counts() -> tuple:
    """The three wrappers' launch counts (read from the ``ops`` modules,
    which :func:`plain_versions` leaves alone)."""
    return tuple(getattr(importlib.import_module(f"{m}.ops"), w).launches
                 for m, (w, _) in WRAPPERS.items())


def graph(n: int, seed: int):
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    return ensure_connected(*barabasi_albert(n, m=4, seed=seed,
                                             weighted=True))


def host_residual(n, r, c, v, b, x) -> float:
    """‖b − Lx‖ / ‖b‖ in float64 on the host, from the input edge list."""
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))
    deg = np.asarray(a.sum(axis=1)).ravel()
    x = x.astype(np.float64)
    res = b.astype(np.float64) - (deg * x - a @ x)
    return float(np.linalg.norm(res) / np.linalg.norm(b))


def phase_build(torch):
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    regs = {name: sorted({int(line.split("Used ")[1].split()[0])
                          for line in out.splitlines() if "Used " in line})
            for name, out in _build.build_info.get("ptxas", {}).items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("build", seconds=round(secs, 2), arch="sm_90a",
        cached=_build.build_info.get("cached"), registers=json.dumps(regs))
    print(smi, flush=True)
    return smi


def phase_main(torch, np):
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.kernels.agg_vote import vote_reduce
    from repro_torch.kernels.jacobi import jacobi_step
    from repro_torch.kernels.spmv_ell import spmv_ell

    t0 = time.perf_counter()
    n, r, c, v = graph(MAIN_N, seed=0)
    gen_s = time.perf_counter() - t0
    say("main", graph=f"barabasi_albert(n={n},m=4,seed=0)",
        undirected_edges=len(r) // 2, stored_nnz=len(r),
        generate_s=round(gen_s, 1))

    spmv_ell.launches = jacobi_step.launches = vote_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = LaplacianSolver.setup(n, r, c, v,
                                   SetupConfig(matvec_backend="ell"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for i, row in enumerate(solver.stats()["levels"]):
        say("main", level=i, kind=row["kind"], n=row["n"], nnz=row["nnz"],
            ell_width=row["ell_width"], ell_spill=row["ell_spill"])
    say("main", setup_s=round(setup_s, 3))

    first_b = None
    for k in range(4):
        b = np.random.default_rng(100 + k).normal(size=n).astype(np.float32)
        b -= b.mean()
        first_b = b if first_b is None else first_b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solver.solve(b, tol=1e-6, maxiter=200)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rel = host_residual(n, r, c, v, b, x.cpu().numpy())
        say("main", rhs=k, iters=info.iters, status=info.status,
            solve_ms=round(ms, 1), wda=round(info.wda, 3),
            host_f64_rel_residual=f"{rel:.3e}")
        check(info.converged, f"solve {k} did not converge: {info.status}")
        check(rel <= 1e-4, f"solve {k}: host residual {rel:.3e} > 1e-4")
    x1, _ = solver.solve(first_b, tol=1e-6, maxiter=200)
    mark = (spmv_ell.launches, jacobi_step.launches)
    x2, info = solver.solve(first_b, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    launches = dict(spmv_ell=spmv_ell.launches, jacobi=jacobi_step.launches,
                    agg_vote=vote_reduce.launches)
    check(torch.equal(x1, x2), "a repeated solve is not bitwise equal")
    say("main", bitwise_repeat=True, launches=json.dumps(launches),
        one_solve_iters=info.iters,
        one_solve_spmv_ell=spmv_ell.launches - mark[0],
        one_solve_jacobi=jacobi_step.launches - mark[1])
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    return solver, launches


def phase_kernels(torch, np, solver, launches):
    from repro_torch.core.aggregation import AggregationConfig, \
        quantise_strength
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.strength import algebraic_distance_strength
    from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref
    from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref
    from repro_torch.sparse.ell import ell_layout_traced

    dev = solver.device
    gen = torch.Generator(device=dev).manual_seed(0)
    before = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    records = []

    def record(name, err, ms, plain_ms, bytes_moved, ops, library_ms=None):
        b_ms, b_by = bound(bytes_moved, ops)
        rec = dict(name=name, route="cuda",
                   source=f"src/repro_torch/csrc/{name}.cu",
                   replaces=REPLACES[name], launches=launches[name],
                   max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        records.append(rec)
        say("kernels", name=name, max_abs_err=err, kernel_ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, bytes=int(bytes_moved))

    # spmv_ell: the finest level's ELL table (every PCG matvec)
    top = solver.hierarchy.transfers[0].fine
    col, val = top.ell.col, top.ell.val
    n, w = col.shape
    x = torch.randn(n, generator=gen, device=dev)
    y, y_ref = spmv_ell(col, val, x), spmv_ell_ref(col, val, x)
    torch.cuda.synchronize()
    check(torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6),
          "spmv_ell disagrees with its plain version")
    real = col < n
    counts = real.sum(dim=1)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():       # sparse CSR is a beta API
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(crow, col[real].long(), val[real],
                                      (n, n), check_invariants=False)
    record("spmv_ell", (y - y_ref).abs().max().item(),
           time_ms(torch, lambda: spmv_ell(col, val, x)),
           time_ms(torch, lambda: spmv_ell_ref(col, val, x)),
           8 * n * w + 4 * n + 4 * n, 2 * int(real.sum()),
           library_ms=time_ms(torch, lambda: torch.mv(csr, x)))

    # jacobi: the first aggregation level's ELL table (its smoothing sweeps)
    agg = next(t for t in solver.hierarchy.transfers
               if isinstance(t, AggregationLevel)).fine
    col, val, deg = agg.ell.col, agg.ell.val, agg.deg
    n, w = col.shape
    x = torch.randn(n, generator=gen, device=dev)
    b = torch.randn(n, generator=gen, device=dev)
    deg0 = deg.clone()
    deg0[::97] = 0.0                       # rows that must keep x as is
    out = jacobi_step(col, val, x, b, deg0)
    out_ref = jacobi_step_ref(col, val, x, b, deg0)
    torch.cuda.synchronize()
    check(torch.allclose(out, out_ref, rtol=1e-5, atol=1e-6),
          "jacobi disagrees with its plain version")
    check(torch.equal(out[::97], x[::97]), "jacobi changed a deg == 0 row")
    record("jacobi", (out - out_ref).abs().max().item(),
           time_ms(torch, lambda: jacobi_step(col, val, x, b, deg)),
           time_ms(torch, lambda: jacobi_step_ref(col, val, x, b, deg)),
           8 * n * w + 16 * n, 2 * int((col < n).sum()) + 6 * n)

    # agg_vote: the first aggregation level's vote layout (width 8) with its
    # quantised strengths, and a mid-round state with Decided neighbours
    cfg = AggregationConfig()
    lay = ell_layout_traced(agg.adj.row, agg.adj.col, agg.n, 8)
    sq = lay.table(quantise_strength(algebraic_distance_strength(agg), cfg))
    state = torch.randint(0, 3, (agg.n,), generator=gen, device=dev,
                          dtype=torch.int32)
    col = lay.col_table
    n, w = col.shape
    err = 0
    for table in (sq, sq % 4):             # real strengths, then many ties
        got = vote_reduce(col, table, state, levels=cfg.strength_levels)
        want = vote_reduce_ref(col, table, state, levels=cfg.strength_levels)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            check(torch.equal(g, r), "agg_vote is not bit-exact")
            err = max(err, (g.long() - r.long()).abs().max().item())
    empty = torch.zeros((n, 0), dtype=torch.int32, device=dev)
    k0 = vote_reduce.launches
    ek, ei = vote_reduce(empty, empty, state, levels=cfg.strength_levels)
    check(vote_reduce.launches == k0, "agg_vote launched at width 0")
    check(bool((ek == torch.iinfo(torch.int32).min).all()
               and (ei == torch.iinfo(torch.int32).max).all()),
          "agg_vote width 0 is not the identity")
    record("agg_vote", err,
           time_ms(torch, lambda: vote_reduce(col, sq, state,
                                              levels=cfg.strength_levels)),
           time_ms(torch, lambda: vote_reduce_ref(
               col, sq, state, levels=cfg.strength_levels)),
           8 * n * w + 4 * n + 8 * n, 4 * int((col < n).sum()))
    after = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    check(all(a > b for a, b in zip(after, before)),
          "a kernel was not launched in the comparison phase")
    return records


def phase_e2e(torch, np):
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    n, r, c, v = graph(E2E_N, seed=1)
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    b -= b.mean()
    out = {}
    for mode, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", plain_versions)):
        before = launch_counts()
        with ctx():
            s = LaplacianSolver.setup(n, r, c, v,
                                      SetupConfig(matvec_backend="ell"))
            x, info = s.solve(b, tol=1e-6, maxiter=200)
        grew = [a > b for a, b in zip(launch_counts(), before)]
        check(all(grew) if mode == "kernel" else not any(grew),
              f"e2e {mode} run launched the wrong kernels: {grew}")
        check(info.converged, f"e2e {mode} solve did not converge")
        out[mode] = (s.stats()["levels"], info.iters, x)
    (lk, ik, xk), (lp, ip, xp) = out["kernel"], out["plain"]
    rel = float(torch.linalg.norm(xk - xp) / torch.linalg.norm(xp))
    say("e2e", n=n, levels=len(lk), same_levels=lk == lp, iters_kernel=ik,
        iters_plain=ip, rel_diff=f"{rel:.3e}")
    check(lk == lp, "kernel and plain runs built different levels")
    check(abs(ik - ip) <= 1, "iteration counts differ by more than 1")
    check(rel <= 1e-4, f"kernel vs plain solutions differ: {rel:.3e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here ({exc})", file=sys.stderr)
        return 2
    import numpy as np

    # the coarse solve's dense product in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = phase_build(torch)
    solver, launches = phase_main(torch, np)
    records = phase_kernels(torch, np, solver, launches)
    del solver
    phase_e2e(torch, np)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
