#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each (any failure exits non-zero):

1. build   — compile the four kernels of ``src/repro_torch/csrc`` for
             sm_90a with nvcc (one process per source, all started
             together); print the seconds and the card's name and power
             limit as nvidia-smi reports them.
2. main    — the paper's solver at the per-process scale of its largest
             run: Barabási–Albert n = 2^20, m = 4 (about 4.2 M undirected
             edges), ``LaplacianSolver.setup(SetupConfig(matvec_backend=
             "ell"))`` (the super-step setup, the default) and four seeded
             mean-free solves at tol 1e-6. Every solve must converge and
             pass a float64 host residual certificate (‖b − Lx‖/‖b‖ ≤
             1e-4); a repeated solve must be bitwise equal; each kernel's
             launch count, reset to 0 just before and read just after, must
             be above 0. Then, as the ``[superstep]`` line, the eager setup
             of the same graph: the levels must agree, the aggregate ids
             and elimination masks and the PCG residual history must be
             bitwise equal, and the super-step setup must have made at most
             one host fetch per constructed level plus 3; with its time,
             peak device memory and registry entries/calls per step.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (spmv_ell and jacobi at rtol 1e-5 /
             atol 1e-6, agg_vote bit-exact), with its times, the plain
             version's, its bound, and for spmv_ell a
             ``torch.sparse_csr_tensor`` product as a yardstick. Two
             times per kernel: ``kernel_ms``, CUDA events over 20
             back-to-back wrapper calls (the wrapper's host time included,
             which is what such a call costs where the host is slower
             than the kernel), and ``device_ms``, the kernel's own device
             time per launch from ``torch.profiler`` over another 20
             calls (``trace_solve.kernel_device_ms``); a record whose
             profile shows no launch of its kernel fails. ``ms``,
             ``of_bound`` and the launches × (time − bound) sums use
             ``device_ms``. Then, as ``[levels]`` lines, spmv_ell and
             jacobi at every ELL level of the main path (launches per
             solve at that level, counted on the main path's last solve)
             and agg_vote at every aggregation level of the main setup,
             on the inputs of the setup's last vote at that level
             (launches per setup; the rows padded to the level's bucket):
             the tile plan, both times against the bound, a check against
             the plain version and a bitwise repeat.
4. facade  — the facade (``repro_torch.api``) on the main graph, after the
             main solver is dropped: ``Problem.from_edges`` and
             ``fingerprint()`` (seconds), ``setup(problem, SolverOptions(
             matvec_backend="ell", tol=1e-6), backend="auto")``, which must
             resolve to ``"single"`` and launch ``agg_vote``; ``solve(b)``
             bitwise equal to the main phase's direct solve of the same b;
             a seeded block of 8 right-hand sides, which must launch
             ``spmv_ell`` and ``jacobi``, converge in every column with a
             float64 host residual ≤ 1e-4, and equal looped single solves
             bit for bit (ms per right-hand side at k = 1 and 8), as must
             the block with guards off and with ``x0`` zeros; a second
             equal setup from the cache (``setup_seconds == 0.0``);
             ``verify="paranoid"`` and ``"cheap"``, bitwise equal with a
             passing certificate (the certificate's seconds; the check's cost per
             iteration by CUDA events on the block's shapes, and from the
             two handles' block solves in turns);
             the ladder under ``inject`` (a NaN SpMV at call 2 and a
             rebuild that raises: status ``"degraded"``, stages exactly
             primary, rebuild, diag_pcg, host residual ≤ 1e-4); a
             ``bitflip`` of the stored edge weights on the paranoid solver
             (flagged ``sdc_spmv``, recovered by the rebuild rung, bitwise
             the direct solve) and, printed only, a ``perturb``; then
             ``build_solve_step`` and the guarded ``pcg_scanned`` under
             ``torch.cuda.set_sync_debug_mode("error")``: code ``SCAN_OK``
             and x within 1e-5 of the eager PCG on the same b.
5. e2e     — the same path at n = 2^16 with the kernels and with the plain
             versions (the setup registry cleared between the two):
             identical levels, iteration counts within ±1 and ‖x_k −
             x_p‖/‖x_p‖ ≤ 1e-4. Then the super-step contracts, at a bucket
             floor of 2^20 so that two graphs of the generator (seeds 1
             and 2) land in the same buckets: a cold super-step setup with
             ``torch.cuda.set_sync_debug_mode("error")`` on from the
             plan's start to its end (lifted only in its host fetches and
             the host work after the last) completes and launches
             ``agg_vote``; the eager loop's host syncs (mode ``"warn"``)
             are counted beside the super-step's fetches; the second graph
             adds no registry entry; the batched setup of both graphs is
             bitwise equal, tensor by tensor, to their single builds.
6. deepfm  — DeepFM serving at full width (``configs/deepfm.py::FULL``: 39
             fields, d = 10, H = 2, MLP 390-400-400-400-1, 3,729,408 table
             rows), weights from a seeded generator: 8 serve_p99 requests
             (B = 512, ``recsys_batch_stream`` steps 0-7, seed 0), one
             serve_bulk batch (B = 262,144) and one retrieval_cand call (one
             user against the 10^6 ids of field 0). Every logit and score
             must be finite; the embedding-bag launch count, reset to 0 just
             before and read just after, must rise by exactly 2 per forward
             and 1 per retrieval; with the wrappers rebound to their plain
             versions the same requests give logits and scores within
             rtol 1e-5 / atol 1e-5 and launch no kernel; 64 retrieval scores
             must match a float64 host computation. Then the kernels phase's
             ``embedding_bag`` record at the bulk batch's shapes (10,223,616
             bags, hot 2, d 10; bitwise equal to the plain version), with
             ``F.embedding_bag`` as a yardstick, the d = 1 ``first_order``
             launch's device time, a case with the sentinel ids −2, −1, V
             and V + 3, and an ids view that does not start on a 16-byte
             boundary (``flat[1:]``), which must launch the kernel.

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
E2E_FLOOR = 1 << 20     # above every level's n and nnz of the e2e graphs
REPLACES = {
    "spmv_ell": "src/repro/kernels/spmv_ell/spmv_ell.py:41",
    "jacobi": "src/repro/kernels/jacobi/jacobi.py:35",
    "agg_vote": "src/repro/kernels/agg_vote/agg_vote.py:51",
    "embedding_bag": "src/repro/kernels/embedding_bag/embedding_bag.py:36",
}
# each kernel package's wrapper and its plain version
WRAPPERS = {
    "repro_torch.kernels.spmv_ell": ("spmv_ell", "spmv_ell_ref"),
    "repro_torch.kernels.jacobi": ("jacobi_step", "jacobi_step_ref"),
    "repro_torch.kernels.agg_vote": ("vote_reduce", "vote_reduce_ref"),
    "repro_torch.kernels.embedding_bag": ("embedding_bag_kernel",
                                          "embedding_bag_ref"),
}
SOLVER_KERNELS = ("repro_torch.kernels.spmv_ell", "repro_torch.kernels.jacobi",
                  "repro_torch.kernels.agg_vote")


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean time of one call, by CUDA events over ``reps`` back-to-back
    calls after a warm-up: the device time where the device is the slower
    side, the host's time per call where the host is."""
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


def device_ms(torch, fn, kernel: str, reps: int = 20) -> float:
    """The device time of one launch of ``kernel`` in ``fn`` (which launches
    it once a call), from ``torch.profiler`` over ``reps`` calls: the mean
    over the launches the profiler saw (it may miss one at the window's
    start); fails if it saw none, or more than one a call."""
    from repro_torch.trace_solve import kernel_device_ms

    ms, count = kernel_device_ms(torch, fn, kernel, reps)
    check(0 < count <= reps, f"{kernel}: the profiler saw {count} launches "
          f"of its kernel in {reps} calls")
    return ms


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def shapes_launched(mods):
    """Within the block, tally the calls of the ELL kernels of ``mods`` by
    table shape: yields {kernel: {(n_rows, width): [calls, args, kw]}},
    with the arguments of the last call at that shape. The wrapper is
    rebound to a function that counts and calls it, so its own launch
    count rises as before."""
    tally = {}
    saved = {}
    for mod_name in mods:
        mod = importlib.import_module(mod_name)
        wrapper_name = WRAPPERS[mod_name][0]
        real = saved[mod_name] = getattr(mod, wrapper_name)
        counts = tally[mod_name.rsplit(".", 1)[1]] = {}

        def counted(col, *args, _real=real, _counts=counts, **kw):
            key = tuple(col.shape)
            calls = _counts[key][0] if key in _counts else 0
            _counts[key] = [calls + 1, (col, *args), kw]
            return _real(col, *args, **kw)

        setattr(mod, wrapper_name, counted)
    try:
        yield tally
    finally:
        for mod_name, real in saved.items():
            setattr(importlib.import_module(mod_name),
                    WRAPPERS[mod_name][0], real)


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


def launch_counts(mods=SOLVER_KERNELS) -> tuple:
    """The launch counts of the wrappers of ``mods`` (read from the ``ops``
    modules, which :func:`plain_versions` leaves alone)."""
    return tuple(getattr(importlib.import_module(f"{m}.ops"),
                         WRAPPERS[m][0]).launches for m in mods)


def hierarchy_tensors(obj, path=""):
    """Every tensor of a hierarchy with its path, in a fixed order."""
    import dataclasses

    if hasattr(obj, "data_ptr"):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from hierarchy_tensors(getattr(obj, f.name),
                                         f"{path}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from hierarchy_tensors(x, f"{path}[{i}]")


def bitwise_equal(torch, ha, hb) -> bool:
    """Two hierarchies with the same structure and every tensor equal bit
    for bit."""
    la, lb = list(hierarchy_tensors(ha)), list(hierarchy_tensors(hb))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == torch.float32:
            x, y = x.reshape(-1).view(torch.int32), y.reshape(-1).view(
                torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def registry_line(ledger: dict) -> str:
    """The setup registry's entries/calls per step."""
    return json.dumps({k: f"{v['compiles']}/{v['calls']}"
                       for k, v in ledger["steps"].items()})


def kernel_record(torch, name, launches, err, kernel, plain, bytes_moved,
                  ops, library=None) -> dict:
    """One kernel's entry of the ``kernels`` JSON line, printed as it is
    made: ``kernel``, ``plain`` and ``library`` are calls to time."""
    b_ms, b_by = bound(bytes_moved, ops)
    k_ms, d_ms = time_ms(torch, kernel), device_ms(torch, kernel, name)
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, library) if library else None
    say("kernels", name=name, max_abs_err=err, kernel_ms=k_ms,
        device_ms=d_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        of_bound=round(b_ms / d_ms, 4), library_ms=library_ms,
        bytes=int(bytes_moved))
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{name}.cu",
                replaces=REPLACES[name], launches=launches,
                max_abs_err=err, ms=d_ms, kernel_ms=k_ms, device_ms=d_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def graph(n: int, seed: int):
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    return ensure_connected(*barabasi_albert(n, m=4, seed=seed,
                                             weighted=True))


def host_residual(n, r, c, v, b, x):
    """‖b − Lx‖ / ‖b‖ in float64 on the host, from the input edge list: a
    float for vectors, one per column for ``(n, k)`` blocks."""
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))
    deg = np.asarray(a.sum(axis=1)).ravel()
    x = x.astype(np.float64)
    if x.ndim == 2:
        deg = deg[:, None]
    res = b.astype(np.float64) - (deg * x - a @ x)
    rel = np.linalg.norm(res, axis=0) / np.linalg.norm(b, axis=0)
    return float(rel) if x.ndim == 1 else rel


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
    from repro_torch.core import setup_step
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
    setup_step.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[2:]) as per_setup:     # agg_vote
        solver = LaplacianSolver.setup(n, r, c, v,
                                       SetupConfig(matvec_backend="ell"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup = dict(setup_s=setup_s, ledger=setup_step.counters(),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
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
    with shapes_launched(SOLVER_KERNELS[:2]) as per_shape:  # spmv, jacobi
        x2, info = solver.solve(first_b, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    launches = dict(spmv_ell=spmv_ell.launches, jacobi=jacobi_step.launches,
                    agg_vote=vote_reduce.launches)
    check(torch.equal(x1, x2), "a repeated solve is not bitwise equal")
    say("main", bitwise_repeat=True, launches=json.dumps(launches),
        one_solve_iters=info.iters,
        one_solve_spmv_ell=spmv_ell.launches - mark[0],
        one_solve_jacobi=jacobi_step.launches - mark[1],
        one_solve_by_shape=json.dumps({k: {f"{n}x{w}": c[0] for (n, w), c
                                           in v.items()}
                                       for k, v in per_shape.items()}),
        setup_agg_vote_by_shape=json.dumps({
            f"{n}x{w}": c[0] for (n, w), c in per_setup["agg_vote"].items()}))
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    for name, mod, start in (("spmv_ell", spmv_ell, mark[0]),
                             ("jacobi", jacobi_step, mark[1])):
        tallied = sum(c[0] for c in per_shape[name].values())
        check(tallied == mod.launches - start,
              f"{name}: {tallied} calls tallied by shape, "
              f"{mod.launches - start} launches in the same solve")
    tallied = sum(c[0] for c in per_setup["agg_vote"].values())
    check(tallied == launches["agg_vote"],
          f"agg_vote: {tallied} calls tallied by shape, "
          f"{launches['agg_vote']} launches in the setup")
    setup.update(graph=(n, r, c, v), b=first_b, info=info,
                 x=x2.cpu().numpy())
    return solver, launches, {**per_shape, **per_setup}, setup


def phase_superstep(torch, solver, setup) -> None:
    """The main path's super-step setup against the eager loop on the same
    graph: levels, aggregate ids and elimination masks, iterations and the
    residual history of the main path's last solve; and its host fetches
    against the one-per-level contract."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    n, r, c, v = setup["graph"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = LaplacianSolver.setup(n, r, c, v, SetupConfig(
        matvec_backend="ell", setup_mode="eager"))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    keys = ("kind", "n", "nnz", "ell_width", "ell_spill")   # capacities differ
    levels_equal = [[row[k] for k in keys] for row in solver.stats()["levels"]] \
        == [[row[k] for k in keys] for row in eager.stats()["levels"]]
    pairs = list(zip(solver.hierarchy.transfers, eager.hierarchy.transfers))
    ids_equal = levels_equal and all(
        torch.equal(ts.coarse_id, te.coarse_id)
        if isinstance(ts, AggregationLevel)
        else torch.equal(ts.elim_mask, te.elim_mask) for ts, te in pairs)
    _, info_e = eager.solve(setup["b"], tol=1e-6, maxiter=200)
    info_s = setup["info"]
    bitwise = info_s.residual_norms == info_e.residual_norms
    syncs = setup["ledger"]["host_syncs"]
    constructed = len(solver.hierarchy.transfers)
    say("superstep", n=n, setup_s=round(setup["setup_s"], 3),
        eager_setup_s=round(eager_s, 3), host_syncs=syncs,
        constructed_levels=constructed, levels_equal=levels_equal,
        ids_bitwise=ids_equal, iters=f"{info_s.iters}/{info_e.iters}",
        residual_norms_bitwise=bitwise,
        peak_gib=round(setup["peak_gib"], 3),
        registry=registry_line(setup["ledger"]))
    check(levels_equal, "super-step and eager setups built different levels")
    check(ids_equal, "super-step and eager aggregates or elimination masks "
          "differ")
    check(info_s.iters == info_e.iters and bitwise,
          "super-step and eager residual histories differ")
    check(syncs <= constructed + 3,
          f"super-step setup fetched {syncs} times for {constructed} levels")


def phase_kernels(torch, np, solver, launches, per_shape):
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref
    from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref

    dev = solver.device
    gen = torch.Generator(device=dev).manual_seed(0)
    before = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    records = []

    def record(name, *args, **kw):
        records.append(kernel_record(torch, name, launches[name], *args,
                                     **kw))

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
           lambda: spmv_ell(col, val, x), lambda: spmv_ell_ref(col, val, x),
           8 * n * w + 4 * n + 4 * n, 2 * int(real.sum()),
           library=lambda: torch.mv(csr, x))

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
           lambda: jacobi_step(col, val, x, b, deg),
           lambda: jacobi_step_ref(col, val, x, b, deg),
           8 * n * w + 16 * n, 2 * int((col < n).sum()) + 6 * n)

    # agg_vote: the main setup's largest vote layout (the first aggregation
    # level, its rows padded to the bucket) with its quantised strengths,
    # and a mid-round state with Decided neighbours
    cfg = AggregationConfig()
    col, sq, _ = per_shape["agg_vote"][max(per_shape["agg_vote"])][1]
    n, w = col.shape
    state = torch.randint(0, 3, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
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
           lambda: vote_reduce(col, sq, state, levels=cfg.strength_levels),
           lambda: vote_reduce_ref(col, sq, state,
                                   levels=cfg.strength_levels),
           8 * n * w + 4 * n + 8 * n, 4 * int((col < n).sum()))
    after = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    check(all(a > b for a, b in zip(after, before)),
          "a kernel was not launched in the comparison phase")
    return records


def phase_levels(torch, solver, per_shape) -> None:
    """spmv_ell and jacobi at every ELL level where the main path's last
    solve ran them, agg_vote at every aggregation level where its setup
    did (``per_shape``, from ``phase_main``): tile plan, both times against
    the bound, and launches per solve or per setup at that level; each
    checked against its plain version and for a bitwise repeat."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.graph import pow2_bucket
    from repro_torch.kernels import ell_tile_plan
    from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref
    from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref

    ts = solver.hierarchy.transfers
    levels = [t.fine for t in ts] + [ts[-1].coarse] if ts else []
    gen = torch.Generator(device=solver.device).manual_seed(1)
    gap = {"spmv_ell": 0.0, "jacobi": 0.0, "agg_vote": 0.0}
    measured = {"spmv_ell": 0, "jacobi": 0, "agg_vote": 0}

    def line(name, i, n, w, kernel, plain, same, bytes_moved, ops, calls,
             unit, **extra):
        got, want = kernel(), plain()
        again = kernel()
        torch.cuda.synchronize()
        check(same(got, want),
              f"{name} disagrees with its plain version at level {i}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{name} is not bitwise repeatable at level {i}")
        k_ms, d_ms = time_ms(torch, kernel), device_ms(torch, kernel, name)
        b_ms, b_by = bound(bytes_moved, ops)
        gap[name] += calls * (d_ms - b_ms)
        measured[name] += 1
        say("levels", kernel=name, level=i, n=n, **extra, width=w,
            plan=json.dumps(ell_tile_plan(w)), kernel_ms=k_ms,
            device_ms=d_ms, bound_ms=b_ms, bound_by=b_by,
            of_bound=round(b_ms / d_ms, 4), **{f"launches_per_{unit}": calls},
            max_abs_err=max(float((g.double() - r.double()).abs().max())
                            for g, r in zip(got, want)))

    for i, level in enumerate(levels):
        ell = getattr(level, "ell", None)
        if ell is None or ell.width == 0:
            continue
        col, val = ell.col, ell.val
        n, w = col.shape
        x = torch.randn(ell.n_cols, generator=gen, device=solver.device)
        b = torch.randn(n, generator=gen, device=solver.device)
        real = int((col < ell.n_cols).sum())
        runs = {
            "spmv_ell": (lambda: (spmv_ell(col, val, x),),
                         lambda: (spmv_ell_ref(col, val, x),),
                         8 * n * w + 4 * ell.n_cols + 4 * n, 2 * real),
            "jacobi": (lambda: (jacobi_step(col, val, x, b, level.deg),),
                       lambda: (jacobi_step_ref(col, val, x, b, level.deg),),
                       8 * n * w + 16 * n, 2 * real + 6 * n),
        }
        for name, (kernel, plain, bytes_moved, ops) in runs.items():
            calls = per_shape[name].get((n, w), [0])[0]
            if calls == 0:                 # not run at this level
                continue
            line(name, i, n, w, kernel, plain,
                 lambda g, r: torch.allclose(g[0], r[0], rtol=1e-5,
                                             atol=1e-6),
                 bytes_moved, ops, calls, "solve")
    # the setup votes at the aggregation levels' rows padded to buckets
    agg_levels = [i for i, t in enumerate(ts)
                  if isinstance(t, AggregationLevel)]
    for (n_cap, w), (calls, args, kw) in sorted(
            per_shape["agg_vote"].items(), reverse=True):
        col, sq, state = args
        real = int(((col >= 0) & (col < n_cap)).sum())
        at = [i for i in agg_levels if pow2_bucket(levels[i].n) == n_cap]
        line("agg_vote", at[0] if at else -1,
             ",".join(str(levels[i].n) for i in at), w,
             lambda: vote_reduce(*args, **kw),
             lambda: vote_reduce_ref(*args, **kw),
             lambda g, r: all(torch.equal(a, b) for a, b in zip(g, r)),
             8 * n_cap * w + 4 * n_cap + 8 * n_cap, 4 * real, calls,
             "setup", n_cap=n_cap)
    for name, count in measured.items():
        check(count > 0, f"{name}: no level of the main path measured")
    say("levels", launches_x_gap_ms=json.dumps(
        dict(spmv_ell_per_solve=gap["spmv_ell"],
             jacobi_per_solve=gap["jacobi"],
             agg_vote_per_setup=gap["agg_vote"])))


def bits_equal(np, a, b) -> bool:
    """Two float32 host arrays equal bit for bit."""
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def phase_facade(torch, np, setup) -> dict:
    """The facade (``repro_torch.api``) on the main graph: the Problem, a
    setup through backend "auto", one and eight right-hand sides against
    the direct solve and looped solves, the cache, paranoid verification,
    the degradation ladder and silent-corruption detection under injected
    faults, and the scanned solve under sync debug mode "error". Returns
    each solver kernel's launches on the facade's path (agg_vote in its
    setup, spmv_ell and jacobi in its solves of one and eight
    right-hand sides, and embedding_bag over the whole phase, which must
    be 0)."""
    from repro_torch.api import Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.core.krylov import SCAN_OK, pcg, pcg_scanned
    from repro_torch.core.verify import certify
    from repro_torch.kernels.agg_vote import vote_reduce
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.jacobi import jacobi_step
    from repro_torch.kernels.spmv_ell import spmv_ell
    from repro_torch.testing import Fault, FaultPlan, inject

    bag_ops.embedding_bag_kernel.launches = 0   # not on the facade's path
    n, r, c, v = setup["graph"]
    b0, x_direct = setup["b"], setup["x"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 1. the problem, and a setup through backend "auto"
    problem, build_s = timed(lambda: Problem.from_edges(n, r, c, v))
    fp, fp_s = timed(problem.fingerprint)
    opts = SolverOptions(matvec_backend="ell", tol=1e-6)
    vote_reduce.launches = 0
    solver, setup_s = timed(lambda: api_setup(problem, opts, backend="auto"))
    votes = vote_reduce.launches
    say("facade", step="problem", n=n, stored_nnz=len(problem.rows),
        from_edges_s=round(build_s, 3), fingerprint_s=round(fp_s, 3),
        fingerprint=fp[:16], backend=solver.backend,
        setup_s=round(setup_s, 3), agg_vote_launches=votes)
    check(solver.backend == "single",
          f"backend auto resolved to {solver.backend!r} on one card")
    check(votes > 0, "the facade's setup launched no agg_vote kernel")

    # 2. one right-hand side, then a block of 8
    spmv_ell.launches = jacobi_step.launches = 0
    (x, res), one_s = timed(lambda: solver.solve(b0))
    B = np.random.default_rng(200).normal(size=(n, 8)).astype(np.float32)
    B -= B.mean(axis=0)
    (X, res_b), block_s = timed(lambda: solver.solve(B))
    launched = dict(spmv_ell=spmv_ell.launches, jacobi=jacobi_step.launches)
    looped_s, same, iters_same = 0.0, [], []
    for j in range(B.shape[1]):
        (xj, rj), sec = timed(lambda: solver.solve(B[:, j]))
        looped_s += sec
        same.append(bits_equal(np, X[:, j], xj))
        iters_same.append(rj.iters == res_b.iters_per_rhs[j])
    rels = host_residual(n, r, c, v, B, X)
    X_ng = solver._handle.solve_block(B, 1e-6, 200, guard=False)[0]
    X_z, _ = solver.solve(B, x0=np.zeros_like(B))
    pairs = dict(guards_off=bits_equal(np, X_ng, X),
                 x0_zeros=bits_equal(np, X_z, X))
    say("facade", step="solve", direct_bitwise=bits_equal(np, x, x_direct),
        iters=res.iters, ms_per_rhs_k1=one_s * 1e3,
        ms_per_rhs_k8=block_s * 1e3 / 8, looped_ms_per_rhs=looped_s * 1e3 / 8,
        block_iters=json.dumps(res_b.iters_per_rhs.tolist()),
        statuses=json.dumps(res_b.statuses.tolist()),
        blocked_vs_looped_bitwise=json.dumps(same),
        bitwise=json.dumps(pairs),
        max_host_f64_rel_residual=f"{rels.max():.3e}",
        launches=json.dumps(launched))
    check(bits_equal(np, x, x_direct),
          "the facade's solve is not bitwise equal to the direct solve")
    check(all(count > 0 for count in launched.values()),
          f"a solver kernel was not launched through the facade: {launched}")
    check(all(same) and all(iters_same),
          "blocked columns differ from looped solves")
    check(all(pairs.values()), f"bitwise pairs {pairs}")
    check(res_b.converged and all(s == "converged" for s in res_b.statuses),
          f"a column did not converge: {res_b.statuses.tolist()}")
    check(bool((rels <= 1e-4).all()), f"host residuals {rels.tolist()}")

    # 3. the cache
    again = api_setup(problem, opts, backend="auto")
    say("facade", step="cache", setup_seconds=again.setup_seconds)
    check(again.setup_seconds == 0.0, "an equal setup missed the cache")

    # 4. paranoid verification; the check's cost from the two handles'
    # block solves in turns (off, paranoid, paranoid, off), no certificate
    popts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="paranoid")
    par, par_setup_s = timed(lambda: api_setup(problem, popts,
                                               backend="auto"))
    (X_p, res_p), par_s = timed(lambda: par.solve(B))
    cert, cert_s = timed(lambda: certify(problem, B, X, 1e-6))
    turns = {False: [], True: []}
    for checked in (False, True, True, False):
        handle = (par if checked else solver)._handle
        turns[checked].append(timed(lambda: handle.solve_block(
            B, 1e-6, 200))[1])
    overhead = ((min(turns[True]) - min(turns[False])) * 1e3
                / max(res_b.iters, 1))
    # what the check adds to one iteration of the block: stacking P and Ap
    # (8 columns each) and the check's reductions, by CUDA events
    cols = [torch.as_tensor(B[:, j], device=par._handle._solver.device)
            for j in range(B.shape[1])]
    chk = par._handle._check
    check_ms = time_ms(torch, lambda: chk(torch.stack(cols, 1),
                                          torch.stack(cols, 1)))
    say("facade", step="verify", mode="paranoid",
        setup_s=round(par_setup_s, 3), bitwise=bits_equal(np, X_p, X),
        certificate_passed=res_p.certificate.passed,
        certificate_max_rel=f"{max(res_p.certificate.rel_residuals):.3e}",
        certificate_s=round(cert_s, 3), solve_ms=par_s * 1e3,
        block_ms_off=json.dumps([round(t * 1e3, 1) for t in turns[False]]),
        block_ms_paranoid=json.dumps([round(t * 1e3, 1)
                                      for t in turns[True]]),
        turns_overhead_ms_per_iteration=round(overhead, 3),
        check_ms_per_iteration=round(check_ms, 4))
    check(bits_equal(np, X_p, X),
          "verify='paranoid' changed the solution bits")
    check(res_p.certificate.passed and cert.passed,
          "the certificate refused a clean solve")
    copts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="cheap")
    x_c, res_c = api_setup(problem, copts, backend="auto").solve(b0)
    say("facade", step="verify", mode="cheap",
        direct_bitwise=bits_equal(np, x_c, x_direct),
        certificate_passed=res_c.certificate.passed)
    check(bits_equal(np, x_c, x_direct) and res_c.certificate.passed,
          "verify='cheap' changed the solution bits or refused it")

    # 5. the ladder: a NaN SpMV in the primary solve, a rebuild that raises
    plan = FaultPlan({"solve.spmv": Fault("nan", at_calls=(2,)),
                      "setup.build": Fault("raise", at_calls=(0,))})
    with inject(plan):
        (x_l, res_l), ladder_s = timed(lambda: solver.solve(b0,
                                                            max_iters=1000))
    stages = [d["stage"] for d in res_l.diagnostics]
    rel_l = host_residual(n, r, c, v, b0, x_l)
    say("facade", step="ladder", status=res_l.status,
        stages=json.dumps(stages), fired=json.dumps(plan.fired),
        rung_statuses=json.dumps([d["status"] for d in res_l.diagnostics]),
        diag_pcg_iters=res_l.iters, seconds=round(ladder_s, 3),
        host_f64_rel_residual=f"{rel_l:.3e}")
    check(res_l.status == "degraded" and plan.fired,
          f"the ladder ended {res_l.status!r}, fired {plan.fired}")
    check(stages == ["primary", "rebuild", "diag_pcg"],
          f"ladder stages {stages}")
    check(rel_l <= 1e-4, f"ladder host residual {rel_l:.3e}")

    # silent corruption of the stored edge weights, on the paranoid solver
    for mode in ("bitflip", "perturb"):
        plan = FaultPlan({"sdc.edge_weights": Fault(mode, at_calls=(0,))})
        with inject(plan):
            (x_s, res_s), sdc_s = timed(lambda: par.solve(b0))
        stages = [d["stage"] for d in res_s.diagnostics]
        primary = res_s.diagnostics[0]["statuses"] if stages else []
        say("facade", step="sdc", mode=mode, status=res_s.status,
            stages=json.dumps(stages), primary=json.dumps(primary),
            certificate_passed=res_s.certificate.passed,
            direct_bitwise=bits_equal(np, x_s, x_direct),
            seconds=round(sdc_s, 3))
        if mode == "bitflip":
            check(primary == ["sdc_spmv"] and stages == ["primary",
                                                         "rebuild"],
                  f"bitflip: primary {primary}, stages {stages}")
            check(res_s.status == "degraded" and res_s.certificate.passed
                  and bits_equal(np, x_s, x_direct),
                  "the rebuild rung did not recover the flagged column")

    # 6. the scanned solve: no host read inside
    lsolver = solver._handle._solver
    b_int = lsolver._to_internal(torch.as_tensor(b0, device=lsolver.device))
    (x_e, info_e), eager_s = timed(lambda: pcg(
        lsolver.matvec, b_int, precond=lsolver.precondition, tol=1e-6,
        maxiter=200))
    step = lsolver.build_solve_step(info_e.iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_u, norms_u = step(b_int)
        x_g, norms_g, code = pcg_scanned(
            lsolver.matvec, b_int, precond=lsolver.precondition,
            n_iters=info_e.iters, guard=True, tol=1e-6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    diffs = [float(torch.linalg.norm(a - x_e) / torch.linalg.norm(x_e))
             for a in (x_u, x_g)]
    say("facade", step="scanned", sync_debug="error", n_iters=info_e.iters,
        code=int(code), rel_diff_unguarded=f"{diffs[0]:.3e}",
        rel_diff_guarded=f"{diffs[1]:.3e}",
        bitwise=bool(torch.equal(x_u, x_e) and torch.equal(x_g, x_e)),
        eager_ms=eager_s * 1e3, two_scanned_ms=scan_s * 1e3)
    check(int(code) == SCAN_OK, f"guarded scanned solve code {int(code)}")
    check(max(diffs) <= 1e-5, f"scanned solves differ from eager: {diffs}")
    bags = bag_ops.embedding_bag_kernel.launches
    check(bags == 0, f"the facade's path launched embedding_bag {bags} times")
    return dict(launched, agg_vote=votes, embedding_bag=bags)


def phase_e2e(torch, np):
    from repro_torch.core import setup_step
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    n, r, c, v = graph(E2E_N, seed=1)
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    b -= b.mean()
    out = {}
    for mode, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", plain_versions)):
        setup_step.clear_cache()
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
    phase_e2e_superstep(torch, [(n, r, c, v), graph(E2E_N, seed=2)])


def phase_e2e_superstep(torch, graphs) -> None:
    """The super-step contracts on two graphs of one generator: steps that
    never sync, the registry reused, batched builds equal to single ones."""
    from repro_torch.core import setup_step as ss
    from repro_torch.core.graph import pow2_bucket
    from repro_torch.core.hierarchy import SetupConfig, build_hierarchy_eager
    from repro_torch.graphs.generators import to_laplacian_coo

    cfg = SetupConfig(matvec_backend="ell", setup_bucket_floor=E2E_FLOOR)
    # one input capacity for both graphs: the ingest step's key holds it
    adjs = [to_laplacian_coo(n, r, c, v, capacity=pow2_bucket(len(r)))
            for n, r, c, v in graphs]
    ss.clear_cache()
    ss.reset_counters()
    votes = launch_counts(SOLVER_KERNELS[2:])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = ss.build_hierarchy_superstep(adjs[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    votes = launch_counts(SOLVER_KERNELS[2:])[0] - votes
    ledger = ss.counters()

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            build_hierarchy_eager(adjs[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager_syncs = sum("synchroniz" in str(w.message) for w in caught)

    ss.reset_counters()
    t0 = time.perf_counter()
    second = ss.build_hierarchy_superstep(adjs[1], cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    new_entries = sum(st["compiles"]
                      for st in ss.counters()["steps"].values())
    ss.reset_counters()
    batch = ss.build_hierarchy_superstep_batch(adjs, cfg)
    batch_ledger = ss.counters()
    same = [bitwise_equal(torch, h, hb)
            for h, hb in zip((first, second), batch)]
    say("e2e", superstep_floor=E2E_FLOOR, sync_debug="error",
        no_sync_in_steps=True, cold_setup_s=round(cold_s, 3),
        host_syncs=ledger["host_syncs"], eager_host_syncs=eager_syncs,
        agg_vote_launches=votes, registry=registry_line(ledger),
        second_graph_new_entries=new_entries, second_setup_s=round(warm_s, 3),
        batch_bitwise=json.dumps(same),
        batch_registry=registry_line(batch_ledger),
        batch_host_syncs=batch_ledger["host_syncs"])
    check(votes > 0, "the super-step setup launched no agg_vote kernel")
    check(new_entries == 0,
          f"a second same-bucket graph added {new_entries} registry entries")
    check(all(same), "batched setups differ from single ones")


def _bag_launches() -> int:
    return launch_counts(("repro_torch.kernels.embedding_bag",))[0]


def phase_deepfm(torch, np):
    """DeepFM serving at FULL: returns the model, the bulk batch's
    fused-table ids and the embedding-bag launches of the served run."""
    from repro_torch.configs.deepfm import FULL, SHAPE_DIMS, serve_flops
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.models.recsys.deepfm import DeepFM, _flat_ids

    cfg, dev = FULL, torch.device("cuda")
    t0 = time.perf_counter()
    model = DeepFM(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say("deepfm", config="FULL", fields=cfg.n_fields, embed_dim=cfg.embed_dim,
        multi_hot=cfg.multi_hot, mlp=cfg.mlp_sizes,
        total_vocab=cfg.total_vocab, table_rows=model.table.shape[0],
        params=n_params, param_mb=round(4 * n_params / 1e6, 1),
        init_s=round(time.perf_counter() - t0, 2))

    b_p99 = SHAPE_DIMS["serve_p99"]["batch"]
    b_bulk = SHAPE_DIMS["serve_bulk"]["batch"]
    n_cand = SHAPE_DIMS["retrieval_cand"]["n_candidates"]
    p99 = recsys_batch_stream(cfg.vocab_per_field, b_p99, cfg.multi_hot,
                              seed=0)
    requests = [next(p99)[1] for _ in range(8)]
    t0 = time.perf_counter()
    bulk_np = next(recsys_batch_stream(cfg.vocab_per_field, b_bulk,
                                       cfg.multi_hot, seed=0))[1]
    gen_s = time.perf_counter() - t0
    user = requests[0][:1]
    cands = torch.arange(n_cand, dtype=torch.int32, device=dev)
    bulk = torch.from_numpy(bulk_np).to(dev)

    def serve(idx_np):                  # host ids in, host logits out
        return model(torch.from_numpy(idx_np).to(dev)).cpu()

    def serve_bulk():
        out = model(bulk)
        torch.cuda.synchronize()
        return out

    def retrieve():
        out = model.retrieval_scores(torch.from_numpy(user).to(dev), cands)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()            # warm-up: cuBLAS handles, shapes
    serve(requests[0])
    serve_bulk()
    retrieve()
    warm_ms = (time.perf_counter() - t0) * 1e3

    bag_ops.embedding_bag_kernel.launches = 0
    torch.cuda.synchronize()
    req_ms, logits, per_call = [], [], []
    for idx in requests:
        k0, t0 = _bag_launches(), time.perf_counter()
        logits.append(serve(idx))
        req_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append(_bag_launches() - k0)
    k0, t0 = _bag_launches(), time.perf_counter()
    bulk_logits = serve_bulk()
    bulk_ms = (time.perf_counter() - t0) * 1e3
    per_call.append(_bag_launches() - k0)
    k0, t0 = _bag_launches(), time.perf_counter()
    scores = retrieve()
    ret_ms = (time.perf_counter() - t0) * 1e3
    per_call.append(_bag_launches() - k0)
    launches = _bag_launches()

    say("deepfm", shape="serve_p99", batch=b_p99, requests=len(requests),
        request_ms_median=float(np.median(req_ms)),
        request_ms_max=max(req_ms),
        request_ms=json.dumps([round(m, 4) for m in req_ms]),
        model_gflop=serve_flops(cfg, b_p99) / 1e9)
    say("deepfm", shape="serve_bulk", batch=b_bulk,
        bags=b_bulk * cfg.n_fields, bulk_ms=bulk_ms,
        examples_per_s=b_bulk / (bulk_ms / 1e3),
        model_gflop=serve_flops(cfg, b_bulk) / 1e9,
        host_batch_gen_s=round(gen_s, 2), warmup_ms=round(warm_ms, 1))
    say("deepfm", shape="retrieval_cand", candidates=n_cand,
        retrieval_ms=ret_ms, launches=launches,
        launches_per_call=json.dumps(per_call))
    check(all(bool(torch.isfinite(x).all())
              for x in (*logits, bulk_logits, scores)),
          "deepfm: a logit or score is not finite")
    check(per_call == [2] * (len(requests) + 1) + [1],
          f"deepfm: embedding_bag launches per call {per_call}, "
          "expected 2 per forward and 1 per retrieval")
    check(launches == 2 * (len(requests) + 1) + 1,
          f"deepfm: embedding_bag launched {launches} times")

    before = launch_counts(tuple(WRAPPERS))
    with plain_versions():
        plain = (serve(requests[0]), serve_bulk(), retrieve())
    check(launch_counts(tuple(WRAPPERS)) == before,
          "deepfm: the plain run launched a kernel")
    errs = []
    for name, got, want in (("serve_p99", logits[0], plain[0]),
                            ("serve_bulk", bulk_logits, plain[1]),
                            ("retrieval", scores, plain[2])):
        errs.append(float((got - want.to(got.device)).abs().max()))
        check(torch.allclose(got, want.to(got.device), rtol=1e-5,
                             atol=1e-5),
              f"deepfm {name}: kernel and plain outputs differ")

    # 64 retrieval scores against float64 on the host
    pick = torch.arange(0, n_cand, n_cand // 64, device=dev)[:64]
    uid = _flat_ids(cfg, torch.from_numpy(user).to(dev))[0, 1:]
    v_user = model.table[uid.reshape(-1).long()].double().sum(0)
    off = int(cfg.field_offsets()[0])
    want = (model.first_order[pick + off, 0].double()
            + model.table[pick + off].double() @ v_user)
    host_err = float((scores[pick].double() - want).abs().max())
    say("deepfm", kernel_vs_plain_max_abs=json.dumps(errs),
        retrieval_vs_f64_max_abs=host_err)
    check(host_err <= 1e-6, "deepfm: retrieval disagrees with float64")
    flat = _flat_ids(cfg, bulk).reshape(-1, cfg.multi_hot)
    return model, flat, launches


def phase_kernels_deepfm(torch, model, flat, launches):
    """The embedding_bag record at the bulk batch's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (embedding_bag_kernel,
                                                   embedding_bag_ref)

    table = model.table.detach()
    w1 = model.first_order.detach()
    n_vocab, d = table.shape
    n_bags, hot = flat.shape
    before = embedding_bag_kernel.launches
    err = 0.0
    for name, t in (("table", table), ("first_order", w1)):
        got, want = embedding_bag_kernel(t, flat), embedding_bag_ref(t, flat)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"embedding_bag on the {name} is not "
              "bitwise equal to its plain version")
        check(torch.equal(embedding_bag_kernel(t, flat), got),
              f"embedding_bag on the {name} is not bitwise repeatable")

    # sentinel ids: −2, −1, V (the reference's pad row) and V + 3
    sent = flat[:100_003].clone()
    pos = torch.arange(0, sent.numel(), 5, device=sent.device)
    bad = torch.tensor([-2, -1, n_vocab, n_vocab + 3], dtype=torch.int32,
                       device=sent.device)
    sent.view(-1)[pos] = bad[torch.arange(len(pos), device=sent.device) % 4]
    sent[:7] = bad[:2]                     # bags of sentinels alone sum to 0
    s_got, s_want = (embedding_bag_kernel(table, sent),
                     embedding_bag_ref(table, sent))
    # an ids view 8 bytes past a 16-byte boundary: read with plain loads
    k0 = embedding_bag_kernel.launches
    view = flat[1:]
    u_got, u_want = (embedding_bag_kernel(table, view),
                     embedding_bag_ref(table, view))
    check(embedding_bag_kernel.launches == k0 + 1 and view.data_ptr() % 16,
          "embedding_bag did not launch on an unaligned ids view")
    empty = flat[:1000, :0]
    k0 = embedding_bag_kernel.launches
    e_got = embedding_bag_kernel(table, empty)
    torch.cuda.synchronize()
    check(torch.equal(s_got, s_want) and not s_got[:7].any(),
          "embedding_bag disagrees with its plain version on sentinel ids")
    check(torch.equal(u_got, u_want),
          "embedding_bag disagrees with its plain version on an unaligned "
          "ids view")
    check(embedding_bag_kernel.launches == k0 and not e_got.any(),
          "embedding_bag at hot 0 launched or did not return zeros")
    say("kernels", name="embedding_bag", bit_exact=True,
        sentinel_max_abs=float((s_got - s_want).abs().max()),
        unaligned_view_max_abs=float((u_got - u_want).abs().max()))

    valid = (flat >= 0) & (flat < n_vocab)
    distinct = int(torch.unique(flat[valid]).numel())
    padded = torch.cat([table, table.new_zeros((1, d))])   # yardstick only
    mapped = torch.where(valid, flat, n_vocab)
    rec = kernel_record(
        torch, "embedding_bag", launches, err,
        lambda: embedding_bag_kernel(table, flat),
        lambda: embedding_bag_ref(table, flat),
        4 * n_bags * hot + 4 * n_bags * d + 4 * d * distinct,
        n_bags * hot * d,
        library=lambda: F.embedding_bag(mapped, padded, mode="sum",
                                        padding_idx=n_vocab))
    say("kernels", name="embedding_bag", bags=n_bags, hot=hot, d=d,
        vocab=n_vocab, distinct_valid_ids=distinct)
    # the d = 1 first-order launch of every forward, at the same ids
    fo = lambda: embedding_bag_kernel(w1, flat)            # noqa: E731
    b_ms, b_by = bound(4 * n_bags * hot + 4 * n_bags + 4 * distinct,
                       n_bags * hot)
    d_ms = device_ms(torch, fo, "embedding_bag")
    say("kernels", name="embedding_bag", shape="first_order", d=1,
        kernel_ms=time_ms(torch, fo), device_ms=d_ms, bound_ms=b_ms,
        bound_by=b_by, of_bound=round(b_ms / d_ms, 4))
    check(embedding_bag_kernel.launches > before,
          "embedding_bag was not launched in the comparison phase")
    return rec


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
    solver, launches, per_shape, setup = phase_main(torch, np)
    phase_superstep(torch, solver, setup)
    records = phase_kernels(torch, np, solver, launches, per_shape)
    phase_levels(torch, solver, per_shape)
    del solver, per_shape
    facade = phase_facade(torch, np, setup)
    del setup
    for rec in records:                 # the facade path's own launches
        rec["facade_launches"] = facade[rec["name"]]
    phase_e2e(torch, np)
    model, flat, bag_launches = phase_deepfm(torch, np)
    records.append(dict(phase_kernels_deepfm(torch, model, flat,
                                             bag_launches),
                        facade_launches=facade["embedding_bag"]))
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
