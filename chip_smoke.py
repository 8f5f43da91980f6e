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
5. paper   — the paper's Fig 3 evaluation (``benchmarks/port_wda.py``).
             (a) The seven graphs of ``PAPER_FIG3`` at the paper's sizes
             (seeded stand-ins, 8,192 to 32,768 vertices), each with one
             seeded mean-free b at tol 1e-8 through the facade's
             ``single`` backend (ours, ``matvec_backend="ell"``, maxiter
             300) and its ``serial_ref`` backend (maxiter 300), both with
             the float64 certificate judging the status, and Jacobi-PCG
             on the graph's Laplacian and its ELL twin (maxiter 4000): one
             ``[paper]`` line a graph with n, nnz, the three WDAs beside
             the paper's, iterations, statuses, setup s, solve ms, the
             float64 host residuals, each solver's launches and, where a
             solver missed 1e-4, the float32 floor (the float64 direct
             solution's residual rounded to float32). No solver may report
             ``converged`` at a host residual above 1e-4. Ours and
             serial_ref must converge to a host residual ≤ 1e-4 unless
             the float32 floor is itself above 1e-4 (no float32 answer
             near the solution meets the bound); ours must launch all
             three solver kernels,
             serial_ref ``spmv_ell`` and ``jacobi`` and no ``agg_vote``,
             Jacobi-PCG ``spmv_ell``; on ``de2010`` ours' WDA must be below
             Jacobi-PCG's. (b) A Delaunay triangulation of 2^20 uniform
             points (unweighted; the class and size of DIMACS10
             delaunay_n20): the super-step setup with ``setup_ell_sweeps``
             off and on and the eager setup with it on, 4 seeded solves
             each at tol 1e-6 (host residual ≤ 1e-4); ``spmv_ell`` must
             launch in setup only with the switch on (tallied by shape and
             aggregation level), and the eager residual histories must be
             bitwise the super-step's; each aggregation level's strength
             stage is timed alone without and with the twin; Jacobi-PCG at
             tol 1e-6 is recorded, not required to converge. Then
             ``spmv_ell`` at every shape the sweeps-on setups launched it
             (both modes), on the setup's own last arguments at that
             shape, against its plain version and for a bitwise repeat.
             The phase's launches (read before these checks) go into the
             kernels JSON as ``paper_launches``.
6. service — the serving layer (``repro_torch.service``) at a serving
             deployment's size: eight Barabási–Albert graphs n = 2^17,
             m = 4, seeds 1–8 (generated in parallel processes, one bucket
             signature) and the main BA 2^20 graph in its own bucket,
             through ``SolverService(SolverOptions(matvec_backend="ell",
             tol=1e-6, verify="cheap"), max_batch=8)``: three tickets per
             2^17 graph (k = 1 and 4 at tol 1e-6, k = 8 at tol 1e-8 with
             max_iters 100) and two on the 2^20 graph (k = 1, 8), seeded
             and mean-free, one ``flush()``. ``stats()`` must show one
             batch of 8 setups, 1 looped, 9 solve blocks and 113 columns;
             every ticket ``converged`` with a passing certificate and a
             float64 host residual ≤ 1e-4 in every column; ``agg_vote``
             launched in the setup pass, ``spmv_ell`` and ``jacobi`` in
             the solve pass. Then, bitwise: the 2^20 graph's and two 2^17
             graphs' tickets against direct facade solves of the same
             columns, a ``max_batch=1`` service on those two graphs
             (batched = looped), and the re-submitted stream (cache hits
             only, no setup seconds); strict admission (the reference
             tests' hopeless grid rejected; a ``service.solve`` fault
             raising at the first group's attempt and retry requeues that
             ticket, served after its backoff); kill and resume (a child
             process on the card serves the two graphs' stream with
             ``checkpoint_every=1`` and is killed in its second group with
             ``KILL_EXIT_CODE``; a fresh service here resumes the snapshot
             and flushes bitwise the uninterrupted results). Prints
             setups/s batched and looped (wall), latency p50/p90/p99,
             solve seconds per column and peak memory, with the card's
             name and power limit. Last, spmv_ell and jacobi at the
             finest shapes of a 2^17 and the 2^20 hierarchy and agg_vote at
             the batched setup's first level, on the flush's own last
             arguments there, against the plain version and for a bitwise
             repeat. The phase's launches (read before those checks) go
             into the kernels JSON as ``service_launches``.
7. spectral — the spectral layer (``repro_torch.spectral``) on a Delaunay
             triangulation of 2^16 uniform points (unweighted), with the
             entry points' default options (``exact_columns=False``) on
             ``matvec_backend="ell"``: ``lobpcg`` k = 8 at tol 1e-8 (all
             pairs converged; eigenvalues within rtol 1e-6 of scipy's
             float64 shift-invert ``eigsh``; iterations, preconditioner
             solves and columns, setup / preconditioner / host-algebra
             seconds, and the unpreconditioned method's residual after as
             many iterations), ``fiedler_bisect`` with and without the
             sweep (the sweep's conductance ≤ the sign cut's),
             ``spectral_clustering(k=4)`` and ``recursive_bisection(
             n_parts=4)`` with their cut quality, ``laplacian_pe(k=8)``
             twice from one cache (the second makes no setup and launches
             no agg_vote; both bitwise equal), and
             ``effective_resistance(n_probes=64)`` (every column's float64
             host residual ≤ 1e-4). All three solver kernels must launch;
             then the same kernel checks as ``service`` at the mesh's
             finest shapes and its setup's first agg_vote level; launches
             as ``spectral_launches``.
8. e2e     — the same path at n = 2^16 with the kernels and with the plain
             versions (the setup registry cleared between the two):
             identical levels, iteration counts within ±1 and ‖x_k −
             x_p‖/‖x_p‖ ≤ 1e-4. Then the super-step contracts, at a bucket
             floor of 2^20 so that two graphs of the generator (seeds 1
             and 2) land in the same buckets: a cold super-step setup with
             ``torch.cuda.set_sync_debug_mode("error")`` on from the
             plan's start to its end (lifted only in its host fetches and
             the host work after the last) completes and launches
             ``agg_vote``, and so does one with ``setup_ell_sweeps`` (its
             own registry entries), which must launch ``spmv_ell``; the
             eager loop's host syncs (mode ``"warn"``)
             are counted beside the super-step's fetches; the second graph
             adds no registry entry; the batched setup of both graphs is
             bitwise equal, tensor by tensor, to their single builds.
9. dist    — the 2D-distributed solver (``repro_torch.dist``). (a) A
             world of one over NCCL on ``cuda:0`` (``init_world``) on the
             main graph, ``matvec_backend="ell"``, the distributed
             super-step, the default split (10,000 nnz, 3 levels): setup
             seconds (the super-step, then the host partition of each
             distributed level) and each level's ``DistLevelMeta``; the
             distributed super-step's hierarchy, built under
             ``torch.cuda.set_sync_debug_mode("error")``, bitwise the
             serial super-step's, with host fetches ≤ constructed levels
             + 3; the main phase's four right-hand sides at tol 1e-6
             through ``DistLaplacianSolver.solve_block``, guarded (codes
             0, float64 host residual ≤ 1e-4 in every column, iterations
             within one of the main phase's ``single`` solves, printed
             where they differ), unguarded and repeated (both bitwise),
             with all-reduce calls and bytes and launches per solve; the
             facade's ``dist`` backend on the same mesh (converged,
             bitwise the direct solve). Then ``spmv_ell`` on every
             distributed level's rank block, ``spmv_ell`` and ``jacobi``
             on the replicated tail and ``agg_vote`` on every row block
             of the setup, each against its plain version with both
             times, the bound and launches per solve column or setup.
             The kernels' launches there go into the kernels JSON as
             ``dist_launches``. (b) BA 2^18 on a 2×2 mesh of four gloo
             processes on the one card (``run_world``, joined under a
             timeout; every reduction staged through host memory): each
             rank's levels and integer decisions equal a world of one's
             on the same graph, equal iterations, the same x in every
             rank, host residual ≤ 1e-4, every solver kernel launched,
             ``spmv_ell`` and ``agg_vote`` at the rank's block shapes
             against their plain versions; and the paper's §2.2 balance
             (``balance_report``) of the finest level with random ordering
             on and off.
10. deepfm — DeepFM serving at full width (``configs/deepfm.py::FULL``: 39
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

Then a ``[total]`` line with the script's seconds. The line before the
last is the card's name and power limit, the one before it the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
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
PAPER_SCALE = 1.0               # the Fig 3 stand-ins at the paper's sizes
PAPER_DELAUNAY_N = 1 << 20      # DIMACS10 delaunay_n20's class and size
E2E_FLOOR = 1 << 20     # above every level's n and nnz of the e2e graphs
# the service and spectral phases' sizes, halved from 2^18 (once and
# twice): their solves are bound by the host's launches (ROADMAP B1), so
# their time falls slower than n
SERVICE_N, SERVICE_GRAPHS = 1 << 17, 8      # one batched setup of eight
SPECTRAL_N = 1 << 16    # Delaunay points of the spectral phase
DIST_RHS = 4            # right-hand sides of the dist phase's solves
DIST_GRID_N = 1 << 18   # the dist phase's 2×2 world: BA n = 2^18
DIST_WORLD_TIMEOUT_S = 400.0
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


def device_ms(torch, fn, kernel: str, reps: int = 20) -> tuple[float, int]:
    """The device time of one launch of ``kernel`` in ``fn`` (which launches
    it once a call), from ``torch.profiler`` over ``reps`` calls: the mean
    over the launches the profiler saw (it may miss one at the window's
    start), and the windows profiled until one saw a launch; fails if it
    saw none, or more than one a call."""
    from repro_torch.trace_solve import kernel_device_ms

    ms, count, windows = kernel_device_ms(torch, fn, kernel, reps)
    check(0 < count <= reps, f"{kernel}: the profiler saw {count} launches "
          f"of its kernel in {reps} calls in {windows} windows")
    return ms, windows


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(name: str, args) -> tuple[int, int]:
    """The bytes an ELL kernel must move (each input read once, each output
    written once) and the operations it does, for its wrapper's positional
    ``args``: ``spmv_ell(col, val, x)``, ``jacobi(col, val, x, b, deg)``,
    ``agg_vote(col, sq, state)``. Only the table's real entries count."""
    col = args[0]
    n, w = col.shape
    n_x = args[2].shape[0]
    if name == "spmv_ell":
        return 8 * n * w + 4 * n_x + 4 * n, 2 * int((col < n_x).sum())
    if name == "jacobi":
        return (8 * n * w + 4 * n_x + 12 * n,
                2 * int((col < n_x).sum()) + 6 * n)
    return (8 * n * w + 4 * n_x + 8 * n,
            4 * int(((col >= 0) & (col < n_x)).sum()))


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
    k_ms, (d_ms, windows) = (time_ms(torch, kernel),
                             device_ms(torch, kernel, name))
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, library) if library else None
    say("kernels", name=name, max_abs_err=err, kernel_ms=k_ms,
        device_ms=d_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        of_bound=round(b_ms / d_ms, 4), library_ms=library_ms,
        bytes=int(bytes_moved), profiler_windows=windows)
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
    iters = []
    for k in range(4):
        b = mean_free_block(np, n, [100 + k])[:, 0]
        first_b = b if first_b is None else first_b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solver.solve(b, tol=1e-6, maxiter=200)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rel = host_residual(n, r, c, v, b, x.cpu().numpy())
        iters.append(info.iters)
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
                 x=x2.cpu().numpy(), iters=iters)
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
           *kernel_work("spmv_ell", (col, val, x)),
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
           *kernel_work("jacobi", (col, val, x, b, deg)))

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
           *kernel_work("agg_vote", (col, sq, state)))
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
        k_ms, (d_ms, windows) = (time_ms(torch, kernel),
                                 device_ms(torch, kernel, name))
        b_ms, b_by = bound(bytes_moved, ops)
        gap[name] += calls * (d_ms - b_ms)
        measured[name] += 1
        say("levels", kernel=name, level=i, n=n, **extra, width=w,
            plan=json.dumps(ell_tile_plan(w)), kernel_ms=k_ms,
            device_ms=d_ms, bound_ms=b_ms, bound_by=b_by,
            of_bound=round(b_ms / d_ms, 4), **{f"launches_per_{unit}": calls},
            profiler_windows=windows, max_abs_err=max(float((g.double() - r.double()).abs().max())
                            for g, r in zip(got, want)))

    for i, level in enumerate(levels):
        ell = getattr(level, "ell", None)
        if ell is None or ell.width == 0:
            continue
        col, val = ell.col, ell.val
        n, w = col.shape
        x = torch.randn(ell.n_cols, generator=gen, device=solver.device)
        b = torch.randn(n, generator=gen, device=solver.device)
        runs = {
            "spmv_ell": (lambda: (spmv_ell(col, val, x),),
                         lambda: (spmv_ell_ref(col, val, x),),
                         *kernel_work("spmv_ell", (col, val, x))),
            "jacobi": (lambda: (jacobi_step(col, val, x, b, level.deg),),
                       lambda: (jacobi_step_ref(col, val, x, b, level.deg),),
                       *kernel_work("jacobi", (col, val, x, b, level.deg))),
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
        at = [i for i in agg_levels if pow2_bucket(levels[i].n) == n_cap]
        line("agg_vote", at[0] if at else -1,
             ",".join(str(levels[i].n) for i in at), w,
             lambda: vote_reduce(*args, **kw),
             lambda: vote_reduce_ref(*args, **kw),
             lambda g, r: all(torch.equal(a, b) for a, b in zip(g, r)),
             *kernel_work("agg_vote", args), calls,
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


def phase_launches() -> dict:
    """Every kernel's launch count, by kernel name."""
    return dict(zip((m.rsplit(".", 1)[1] for m in WRAPPERS),
                    launch_counts(tuple(WRAPPERS))))


def zero_launches() -> None:
    for mod_name, (wrapper, _) in WRAPPERS.items():
        getattr(importlib.import_module(f"{mod_name}.ops"),
                wrapper).launches = 0


def phase_paper(torch, np) -> dict:
    """The paper's Fig 3 evaluation on the card. (a) The seven graphs of
    ``PAPER_FIG3`` at the paper's sizes, each through the facade's
    ``single`` (ours) and ``serial_ref`` backends under the float64
    certificate, and Jacobi-PCG (``benchmarks/port_wda.py``'s
    ``fig3_row``). (b) A Delaunay triangulation of 2^20 points through the
    super-step setup with ``setup_ell_sweeps`` off and on, the eager setup
    with it on, and Jacobi-PCG; then the sweeps' ``spmv_ell`` shapes
    against the plain version. Returns each kernel's launches over the
    phase before that check."""
    from benchmarks.port_wda import PAPER_FIG3, fig3_row

    t0 = time.perf_counter()
    zero_launches()
    ok_status = ("converged", "max_iters")
    for name in PAPER_FIG3:
        row = fig3_row(torch, name, scale=PAPER_SCALE, tol=1e-8, seed=0)
        ours, ser, jac = row["ours"], row["serial_ref"], row["jacobi_pcg"]
        floor = row["float32_floor"]
        say("paper", graph=name, n=row["n"], nnz=row["nnz"],
            wda=json.dumps(dict(serial_ref=ser["wda"], ours=ours["wda"],
                                jacobi_pcg=jac["wda"])),
            paper=json.dumps(dict(lamg=row["paper_lamg"],
                                  ours=row["paper_ours"],
                                  pcg=row["paper_pcg"])),
            iters=f"{ser['iters']}/{ours['iters']}/{jac['iters']}",
            status=f"{ser['status']}/{ours['status']}/{jac['status']}",
            levels=f"{ser['levels']}/{ours['levels']}",
            setup_s=f"{ser['setup_s']:.3f}/{ours['setup_s']:.3f}",
            solve_ms=f"{ser['solve_ms']:.1f}/{ours['solve_ms']:.1f}/"
                     f"{jac['solve_ms']:.1f}",
            host_f64_rel_residual=f"{ser['host_residual']:.3e}/"
                                  f"{ours['host_residual']:.3e}/"
                                  f"{jac['host_residual']:.3e}",
            float32_floor=json.dumps(floor),
            launches=json.dumps(dict(serial_ref=ser["launches"],
                                     ours=ours["launches"],
                                     jacobi_pcg=jac["launches"])))
        for who, res in (("ours", ours), ("serial_ref", ser),
                         ("jacobi_pcg", jac)):
            check(res["status"] != "converged" or res["host_residual"] <= 1e-4,
                  f"{name} {who}: reports converged at host residual "
                  f"{res['host_residual']:.3e}")
        # the bound is required unless the float64 solution rounded to
        # float32 already misses it: then the status check above holds
        beyond_f32 = floor is not None and floor["f32_rounded_residual"] > 1e-4
        for who, res in (("ours", ours), ("serial_ref", ser)):
            check(beyond_f32 or (res["host_residual"] <= 1e-4
                                 and res["status"] in ok_status),
                  f"{name} {who}: status {res['status']}, host residual "
                  f"{res['host_residual']:.3e}, float32 floor {floor}")
        check(all(v > 0 for v in ours["launches"].values()),
              f"{name} ours launched {ours['launches']}")
        check(ser["launches"]["spmv_ell"] > 0 and ser["launches"]["jacobi"] > 0
              and ser["launches"]["agg_vote"] == 0,
              f"{name} serial_ref launched {ser['launches']}")
        check(jac["launches"]["spmv_ell"] > 0,
              f"{name} Jacobi-PCG launched {jac['launches']}")
        if name == "de2010":
            check(ours["wda"] < jac["wda"], f"de2010: ours' WDA "
                  f"{ours['wda']:.3f} is not below Jacobi-PCG's "
                  f"{jac['wda']:.3f}")
    sweeps_shapes = phase_paper_delaunay(torch, np)
    launched = phase_launches()
    check_setup_sweeps(torch, sweeps_shapes)
    say("paper", seconds=round(time.perf_counter() - t0, 1))
    return launched


def check_setup_sweeps(torch, shapes) -> None:
    """``spmv_ell`` at every (rows, width) where a sweeps-on setup launched
    it, on that setup's last arguments at the shape
    (``check_kernel_shapes``)."""
    check_kernel_shapes(torch, "paper", [
        ("spmv_ell", shape, entry, dict(step="setup_spmv_ell",
                                        setup_mode=mode))
        for mode, tally in shapes.items()
        for shape, entry in sorted(tally.items())])


def check_kernel_shapes(torch, phase, picks) -> None:
    """Each solver kernel on a phase's own last arguments at a shape it
    launched at: ``picks`` holds ``(kernel, (rows, width), (calls, args,
    kw), labels)`` from ``shapes_launched``. Against the plain version
    (spmv_ell and jacobi at rtol 1e-5 / atol 1e-6, agg_vote bit-exact) and
    for a bitwise repeat."""
    for name, (rows, w), (calls, args, kw), labels in picks:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        wrapper, ref = WRAPPERS[mod.__name__]
        run, plain = getattr(mod, wrapper), getattr(mod, ref)
        got, want, again = (run(*args, **kw), plain(*args, **kw),
                            run(*args, **kw))
        torch.cuda.synchronize()
        got, want, again = ((o,) if torch.is_tensor(o) else tuple(o)
                            for o in (got, want, again))
        err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, want))
        say(phase, **labels, kernel=name, rows=rows, width=w,
            launches=calls, max_abs_err=err)
        where = f"{phase} {name} ({labels}, {rows}x{w})"
        if name == "agg_vote":
            check(all(torch.equal(g, r) for g, r in zip(got, want)),
                  f"{where} is not bit-exact against its plain version")
        else:
            check(all(torch.allclose(g, r, rtol=1e-5, atol=1e-6)
                      for g, r in zip(got, want)),
                  f"{where} disagrees with its plain version: max abs err "
                  f"{err:.3e}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{where} is not bitwise repeatable")


def phase_paper_delaunay(torch, np) -> dict:
    """Part (b): Delaunay n = 2^20 (unweighted, planar; the class and size
    of DIMACS10 delaunay_n20), the super-step setup with
    ``setup_ell_sweeps`` off and on (spmv_ell launched in setup only with it
    on, tallied by shape), 4 seeded solves each at tol 1e-6 with a float64
    host residual ≤ 1e-4, the eager setup with it on (residual histories
    bitwise the super-step's), each aggregation level's strength stage
    timed alone without and with the twin, and Jacobi-PCG (recorded, not
    required to converge, never reporting a convergence that the host
    residual refutes). Returns the sweeps-on setups' ``spmv_ell`` calls by
    shape, each with its last arguments, by setup mode."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.graph import attach_setup_twin, pow2_bucket
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.krylov import jacobi_pcg
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.core.strength import algebraic_distance_strength
    from repro_torch.core.wda import wda
    from repro_torch.graphs.generators import delaunay, ensure_connected
    from repro_torch.kernels.spmv_ell import spmv_ell
    from repro_torch.sparse.ell import ell_layout_traced

    t0 = time.perf_counter()
    n, r, c, v = ensure_connected(*delaunay(PAPER_DELAUNAY_N, seed=0))
    gen_s = time.perf_counter() - t0
    deg = np.bincount(r, minlength=n)
    say("paper", graph=f"delaunay(n={n},seed=0)", stored_nnz=len(r),
        max_degree=int(deg.max()), degree_p95=float(np.percentile(deg, 95)),
        generate_s=round(gen_s, 1))
    rhs = []
    for k in range(4):
        b = np.random.default_rng(300 + k).normal(size=n).astype(np.float32)
        rhs.append(b - b.mean())

    def run(sweeps, mode):
        cfg = SetupConfig(matvec_backend="ell", setup_ell_sweeps=sweeps,
                          setup_mode=mode)
        torch.cuda.synchronize()
        k0, t0 = spmv_ell.launches, time.perf_counter()
        with shapes_launched(SOLVER_KERNELS[:1]) as tally:
            solver = LaplacianSolver.setup(n, r, c, v, cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        in_setup = spmv_ell.launches - k0
        ts = solver.hierarchy.transfers
        agg_ns = [t.fine.n for t in ts if isinstance(t, AggregationLevel)]
        by_level = {}
        for (rows, w), (calls, _, _) in tally["spmv_ell"].items():
            at = [m for m in agg_ns if rows in (m, pow2_bucket(m))]
            by_level[f"{','.join(map(str, at)) or '?'}:{rows}x{w}"] = calls
        solves = []
        for k, b in enumerate(rhs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = solver.solve(b, tol=1e-6, maxiter=200)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rel = host_residual(n, r, c, v, b, x.cpu().numpy())
            solves.append((info, ms, rel))
            check(info.converged and rel <= 1e-4,
                  f"delaunay sweeps={sweeps} {mode} rhs {k}: {info.status}, "
                  f"host residual {rel:.3e}")
        say("paper", graph="delaunay_2^20", setup_ell_sweeps=sweeps,
            setup_mode=mode, setup_s=round(setup_s, 3),
            levels=json.dumps([(row["kind"], row["n"])
                               for row in solver.stats()["levels"]]),
            setup_spmv_ell_launches=in_setup,
            setup_spmv_ell_by_level=json.dumps(by_level),
            iters=json.dumps([s[0].iters for s in solves]),
            solve_ms=json.dumps([round(s[1], 1) for s in solves]),
            wda=round(solves[0][0].wda, 3),
            host_f64_rel_residual=f"{max(s[2] for s in solves):.3e}")
        return (solver, in_setup, [s[0].residual_norms for s in solves],
                tally["spmv_ell"])

    off, off_launches, _, _ = run(False, "superstep")
    check(off_launches == 0, f"spmv_ell launched {off_launches} times in a "
          "setup without setup_ell_sweeps")
    del off
    on, on_launches, hist_on, shapes_on = run(True, "superstep")
    check(on_launches > 0, "spmv_ell was not launched in a setup with "
          "setup_ell_sweeps")
    eager, _, hist_eager, shapes_eager = run(True, "eager")
    check(hist_on == hist_eager, "setup_ell_sweeps: eager and super-step "
          "residual histories differ")
    del eager

    # the strength stage alone at each aggregation level, without and with
    # the setup twin (the super-step runs it on bucket-padded levels)
    strength_s = {False: 0.0, True: 0.0}
    for t in on.hierarchy.transfers:
        if not isinstance(t, AggregationLevel):
            continue
        level = dataclasses.replace(t.fine, ell=None, ell_rem=None)
        twin = attach_setup_twin(level, ell_layout_traced(
            level.adj.row, level.adj.col, level.n, 8))
        for sweeps, lv in ((False, level), (True, twin)):
            algebraic_distance_strength(lv)            # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            algebraic_distance_strength(lv)
            torch.cuda.synchronize()
            strength_s[sweeps] += time.perf_counter() - t0

    fine = on.hierarchy.transfers[0].fine
    b_int = on._to_internal(torch.as_tensor(rhs[0], device=on.device))
    k0 = spmv_ell.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_j, info_j = jacobi_pcg(fine, b_int, tol=1e-6, maxiter=4000)
    torch.cuda.synchronize()
    jac_ms = (time.perf_counter() - t0) * 1e3
    rel_j = host_residual(n, r, c, v, rhs[0],
                          on._from_internal(x_j).cpu().numpy())
    say("paper", graph="delaunay_2^20", eager_vs_superstep_bitwise=True,
        strength_s_warm=json.dumps({"coo": strength_s[False],
                                    "ell_twin": strength_s[True]}),
        jacobi_pcg_iters=info_j.iters, jacobi_pcg_status=info_j.status,
        jacobi_pcg_wda=round(wda(info_j.residual_norms, 1.0), 3),
        jacobi_pcg_ms=round(jac_ms, 1),
        jacobi_pcg_host_f64_rel_residual=f"{rel_j:.3e}",
        jacobi_pcg_spmv_ell=spmv_ell.launches - k0)
    check(spmv_ell.launches > k0, "Jacobi-PCG launched no spmv_ell")
    check(info_j.status != "converged" or rel_j <= 1e-4, "delaunay Jacobi-PCG "
          f"reports converged at host residual {rel_j:.3e}")
    return {"superstep": shapes_on, "eager": shapes_eager}


def finest_picks(solver, tally, labels) -> list:
    """``check_kernel_shapes`` picks for spmv_ell at the finest level of
    ``solver``'s hierarchy (every PCG matvec) and jacobi at its first
    aggregation level (the finest it smooths), from ``tally``."""
    from repro_torch.core.coarsen import AggregationLevel

    ts = solver.hierarchy.transfers
    agg = next(t for t in ts if isinstance(t, AggregationLevel)).fine
    picks = []
    for name, level in (("spmv_ell", ts[0].fine), ("jacobi", agg)):
        shape = tuple(level.ell.col.shape)
        check(shape in tally[name], f"{labels}: {name} was not launched at "
              f"the finest shape {shape}")
        picks.append((name, shape, tally[name][shape], labels))
    return picks


def hopeless_graph():
    """``tests/test_service_checkpoint.py``'s hopeless problem: a grid
    12×12 with a pair-symmetric 1e16 weight scaling, beyond float32."""
    import numpy as np

    from repro_torch.graphs.generators import ensure_connected, grid_2d

    n, r, c, v = ensure_connected(*grid_2d(12, 12))
    v = np.where(np.minimum(r, c) % 2 == 0, np.asarray(v) * 1e16,
                 np.asarray(v, np.float64))
    return n, r, c, v


KILL_CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.api import Problem, SolverOptions
from repro_torch.service import SolverService
from repro_torch.testing import Fault, FaultPlan, inject

d = np.load({npz!r})
reqs = json.loads({reqs!r})
problems = [Problem.from_edges(int(d[f"n{{g}}"]), d[f"r{{g}}"], d[f"c{{g}}"],
                               d[f"v{{g}}"]) for g in range(2)]
svc = SolverService(SolverOptions(matvec_backend="ell", tol=1e-6,
                                  verify="cheap", checkpoint_every=1,
                                  device={device!r}),
                    max_batch=8, checkpoint_dir={ckpt!r})
for j, (g, kw) in enumerate(reqs):
    svc.submit(problems[g], d[f"b{{j}}"], **kw)
if any(m.split(".")[0] in ("jax", "repro") for m in sys.modules):
    sys.exit(3)
with inject(FaultPlan({{"service.solve": Fault(mode="kill",
                                              at_calls=(1,))}})):
    svc.flush()
sys.exit("the kill fault did not fire")
"""


def phase_service(torch, np, main_graph, smi) -> dict:
    """A stream of solves through ``repro_torch.service.SolverService`` at
    a serving deployment's size: eight BA 2^17 graphs (one bucket, one
    batched setup) and the main BA 2^20 graph (looped), 113 right-hand
    sides in 26 requests and one flush; then the contracts (direct solves,
    batched = looped, the re-submitted stream, strict admission, kill and
    resume) and the kernels at the flush's finest shapes. Returns each
    kernel's launches over the phase before that check."""
    import shutil

    from benchmarks.port_service import ba_graphs, stream
    from repro_torch.api import HierarchyCache, Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.device import resolve_device
    from repro_torch.service import SolverService
    from repro_torch.testing import KILL_EXIT_CODE, Fault, FaultPlan, inject

    t_phase = time.perf_counter()
    graphs = ba_graphs(SERVICE_N, range(1, SERVICE_GRAPHS + 1))
    gen_s = time.perf_counter() - t_phase
    graphs.append(main_graph)
    t0 = time.perf_counter()
    problems = [Problem.from_edges(*g) for g in graphs]
    for p in problems:
        p.fingerprint()
    prob_s = time.perf_counter() - t0
    sigs = [p.bucket_signature() for p in problems]
    say("service", graphs=f"{SERVICE_GRAPHS} x barabasi_albert(n="
        f"{SERVICE_N},m=4,seeds 1-{SERVICE_GRAPHS}) + main "
        f"n={main_graph[0]}",
        stored_nnz=json.dumps([len(g[1]) for g in graphs]),
        buckets=json.dumps(sorted(set(sigs))), generate_s=round(gen_s, 1),
        problems_s=round(prob_s, 1), card=smi)
    check(len(set(sigs[:-1])) == 1 and sigs[-1] != sigs[0],
          f"the service graphs' bucket signatures {sigs}")
    main_i = len(problems) - 1
    rng = np.random.default_rng(1)
    requests = stream(problems[:-1])
    for k in (1, 8):
        B = rng.normal(size=(problems[main_i].n, k)).astype(np.float32)
        B -= B.mean(axis=0)
        requests.append((main_i, B[:, 0] if k == 1 else B, {}))
    opts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="cheap")

    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = SolverService(opts, max_batch=8)
    passes, batched_votes = {}, {}

    def instrument(service, name, after=None):
        real = getattr(service, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            k0, t0 = phase_launches(), time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            passes[name] = dict(seconds=time.perf_counter() - t0, launches={
                k: v - k0[k] for k, v in phase_launches().items()})
            if after:
                after()
            return out

        setattr(service, name, run)

    with shapes_launched(SOLVER_KERNELS) as tally:
        instrument(svc, "_setup_pass")
        instrument(svc, "_solve_pass")
        instrument(svc, "_setup_batched",
                   after=lambda: batched_votes.update(tally["agg_vote"]))
        t0 = time.perf_counter()
        tickets = [svc.submit(problems[i], B, **kw) for i, B, kw in requests]
        svc.flush()
        flush_s = time.perf_counter() - t0
    st = svc.stats()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    counts = {k: st[k] for k in ("setup_batches", "setups_batched",
                                 "setups_looped", "solve_blocks",
                                 "rhs_columns")}
    # float64 host residuals, one pass over each graph's columns
    worst, bad = 0.0, []
    for i, (n, r, c, v) in enumerate(graphs):
        mine = [(t, B) for t, (j, B, _) in zip(tickets, requests) if j == i]
        Bs = np.concatenate([B.reshape(n, -1) for _, B in mine], axis=1)
        Xs = np.concatenate([t.result()[0].reshape(n, -1) for t, _ in mine],
                            axis=1)
        rels = host_residual(n, r, c, v, Bs, Xs)
        worst = max(worst, float(rels.max()))
        for t, _ in mine:
            res = t.result()[1]
            if not (res.status == "converged" and res.certificate.passed):
                bad.append((t.seq, res.status))
        if (rels > 1e-4).any():
            bad.append((i, "host residual", float(rels.max())))
    lat = st["latency_seconds"]
    say("service", step="flush", flush_s=round(flush_s, 3),
        counters=json.dumps(counts), setup_s=round(st["setup_seconds"], 3),
        batched_setup_s=passes.get("_setup_batched", {}).get("seconds"),
        solve_s=round(st["solve_seconds"], 3),
        solve_s_per_rhs_column=st["solve_seconds"] / st["rhs_columns"],
        latency_p50_p90_p99_s=json.dumps([lat["p50"], lat["p90"],
                                          lat["p99"]]),
        peak_gib=round(peak_gib, 3),
        max_host_f64_rel_residual=f"{worst:.3e}",
        setup_pass_launches=json.dumps(passes["_setup_pass"]["launches"]),
        solve_pass_launches=json.dumps(passes["_solve_pass"]["launches"]),
        card=smi)
    check(counts == dict(setup_batches=1, setups_batched=SERVICE_GRAPHS,
                         setups_looped=1, solve_blocks=SERVICE_GRAPHS + 1,
                         rhs_columns=13 * SERVICE_GRAPHS + 9),
          f"service counters {counts}")
    check(not bad, f"tickets not converged, certified and within 1e-4: {bad}")
    check(passes["_setup_pass"]["launches"]["agg_vote"] > 0,
          "the setup pass launched no agg_vote")
    check(all(passes["_solve_pass"]["launches"][k] > 0
              for k in ("spmv_ell", "jacobi")),
          "the solve pass launched no spmv_ell or jacobi")

    # the tickets of the 2^20 graph and two of the eight against direct
    # facade solves of the same columns on the same hierarchies
    direct = [bits_equal(np, t.result()[0], api_setup(
        problems[i], opts, cache=svc.cache).solve(B, **kw)[0])
              for t, (i, B, kw) in zip(tickets, requests)
              if i in (0, 1, main_i)]
    # batched = looped: the same two graphs through a max_batch=1 service
    looped_svc = SolverService(opts, max_batch=1)
    pair = [(t, i, B, kw) for t, (i, B, kw) in zip(tickets, requests)
            if i in (0, 1)]
    looped = [looped_svc.submit(problems[i], B, **kw) for _, i, B, kw in pair]
    looped_svc.flush()
    lst = looped_svc.stats()
    same_looped = [bits_equal(np, t.result()[0], u.result()[0])
                   for (t, *_), u in zip(pair, looped)]
    del looped_svc, looped
    # the re-submitted stream: cache hits only, no setup, the same bits
    before = svc.stats()
    again = [svc.submit(problems[i], B, **kw) for i, B, kw in requests]
    svc.flush()
    after = svc.stats()
    hits = after["cache"]["hits"] - before["cache"]["hits"]
    same_again = all(bits_equal(np, t.result()[0], u.result()[0])
                     for t, u in zip(tickets, again))
    batched_rate = SERVICE_GRAPHS / passes["_setup_batched"]["seconds"]
    looped_rate = lst["setups_looped"] / lst["setup_seconds"]
    say("service", step="contracts", direct_bitwise=all(direct),
        direct_tickets=len(direct), looped_bitwise=all(same_looped),
        setups_per_s_batched=batched_rate, setups_per_s_looped=looped_rate,
        batched_over_looped=batched_rate / looped_rate,
        resubmit_hits=hits,
        resubmit_misses=after["cache"]["misses"] - before["cache"]["misses"],
        resubmit_setup_s=after["setup_seconds"] - before["setup_seconds"],
        resubmit_bitwise=same_again, card=smi)
    check(all(direct), "service results differ from direct facade solves")
    check(lst["setups_looped"] == 2 and all(same_looped),
          "batched setups differ from looped ones")
    check(hits == main_i + 1 and after["cache"]["misses"]
          == before["cache"]["misses"]
          and after["setup_seconds"] == before["setup_seconds"]
          and same_again, "the re-submitted stream set up again or differs")

    # strict admission: the hopeless problem is turned away; a raising
    # serve requeues its ticket and the rest of the flush completes
    strict = SolverService(opts, max_batch=8, cache=svc.cache,
                           admission="strict")
    b_h = rng.normal(size=144).astype(np.float32)
    rejected = strict.submit(Problem.from_edges(*hopeless_graph()),
                             b_h - b_h.mean())
    picked = [j for j, (i, _, _) in enumerate(requests) if i in (0, 1)][::3]
    plan = FaultPlan({"service.solve": Fault(mode="raise",
                                             at_calls=(0, 1))})
    with inject(plan):
        sts = [strict.submit(problems[requests[j][0]], requests[j][1],
                             **requests[j][2]) for j in picked]
        strict.flush()
    first = [t.status for t in sts]
    strict.flush()
    strict.flush()
    requeued = [t for t, s0 in zip(sts, first) if s0 == "requeued"]
    sst = strict.stats()
    say("service", step="strict", rejected=rejected.status,
        statuses_after_fault=json.dumps(first),
        statuses_after_backoff=json.dumps([t.status for t in sts]),
        requeued=sst["requeued"], rejected_count=sst["rejected"],
        fired=json.dumps(plan.fired))
    check(rejected.status == "rejected", "strict admission admitted the "
          "hopeless problem")
    check(sorted(first) == ["done", "requeued"] and sst["requeued"] == 1,
          f"strict admission after a raising serve: {first}")
    check(all(t.status == "done" for t in sts) and all(
        bits_equal(np, t.result()[0], tickets[j].result()[0])
        for t, j in zip(sts, picked)),
        "the requeued ticket was not served, or differs")

    # kill and resume: a child process on the card serves the two
    # graphs' stream with snapshots and is killed in its second group
    work = ROOT / "build" / "service_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt, npz = str(work / "ckpt"), str(work / "stream.npz")
    arrays, reqs = {}, []
    for g in (0, 1):
        n, r, c, v = graphs[g]
        arrays.update({f"n{g}": n, f"r{g}": r, f"c{g}": c, f"v{g}": v})
    for j, (_, i, B, kw) in enumerate(pair):
        arrays[f"b{j}"] = B
        reqs.append((i, kw))
    np.savez(npz, **arrays)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", KILL_CHILD.format(
            src=str(ROOT / "src"), npz=npz, reqs=json.dumps(reqs),
            ckpt=ckpt, device=str(resolve_device(None)))],
        capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    fresh = SolverService(opts, max_batch=8, cache=svc.cache,
                          checkpoint_dir=ckpt)
    resumed_t = [fresh.submit(problems[i], B, **kw) for _, i, B, kw in pair]
    resumed = fresh.resume()
    fresh.flush()
    same_resume = [bits_equal(np, t.result()[0], u.result()[0])
                   for (t, *_), u in zip(pair, resumed_t)]
    say("service", step="kill_resume", child_exit=child.returncode,
        child_s=round(child_s, 1), resumed=resumed,
        bitwise=json.dumps(same_resume), card=smi)
    check(child.returncode == KILL_EXIT_CODE,
          f"the killed child exited {child.returncode}: "
          f"{child.stderr[-3000:]}")
    check(resumed > 0 and all(same_resume),
          "the resumed flush differs from the uninterrupted one")
    shutil.rmtree(work, ignore_errors=True)

    launched = phase_launches()
    check(launched["embedding_bag"] == 0,
          "the service phase launched embedding_bag")
    picks = []
    for i in (0, main_i):
        handle = svc.cache.peek(HierarchyCache.key(problems[i], opts,
                                                   svc.backend))
        picks += finest_picks(handle._solver, tally,
                              dict(graph=f"ba_n{problems[i].n}"))
    first_vote = max(batched_votes)
    picks.append(("agg_vote", first_vote, batched_votes[first_vote],
                  dict(graph="batched setup")))
    check_kernel_shapes(torch, "service", picks)
    say("service", seconds=round(time.perf_counter() - t_phase, 1),
        launches=json.dumps(launched), card=smi)
    return launched


@contextlib.contextmanager
def timed_solves(seconds: list):
    """Within the block, add the wall seconds of every facade
    ``Solver.solve`` (which returns host arrays) to ``seconds[0]``."""
    from repro_torch.api.facade import Solver

    real = Solver.solve

    def solve(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return real(self, *args, **kw)
        finally:
            seconds[0] += time.perf_counter() - t0

    Solver.solve = solve
    try:
        yield
    finally:
        Solver.solve = real


def phase_spectral(torch, np, smi) -> dict:
    """The spectral layer (``repro_torch.spectral``) on a Delaunay mesh of
    2^16 uniform points: LOBPCG k = 8 at tol 1e-8 against scipy's
    shift-invert ``eigsh``, Fiedler bisection with and without the sweep,
    spectral clustering and recursive bisection into 4, two positional
    encodings from one cache, the resistance sketch with 64 probes; then
    the kernels at the mesh's finest shapes. Returns each kernel's
    launches over the phase before that check."""
    from scipy.sparse.linalg import eigsh

    from repro_torch.api import HierarchyCache, Problem
    from repro_torch.graphs.generators import delaunay, ensure_connected
    from repro_torch.spectral import (effective_resistance, fiedler_bisect,
                                      laplacian_pe, lobpcg,
                                      recursive_bisection,
                                      spectral_clustering)
    from repro_torch.spectral.lobpcg import _default_options, _laplacian_csr
    from repro_torch.spectral.resistance import _incidence_rhs

    # the entry points' default options (exact_columns=False), with the
    # ELL backend as on every other path of this script: the reference's
    # default "coo" would run no spmv_ell or jacobi
    opts = dataclasses.replace(_default_options(SPECTRAL_N, None),
                               matvec_backend="ell")

    t_phase = time.perf_counter()
    n, r, c, v = ensure_connected(*delaunay(SPECTRAL_N, seed=0))
    p = Problem.from_edges(n, r, c, v)
    say("spectral", graph=f"delaunay(n={n},seed=0)", stored_nnz=len(r),
        generate_s=round(time.perf_counter() - t_phase, 1), card=smi)
    cache = HierarchyCache()
    zero_launches()
    with shapes_launched(SOLVER_KERNELS) as tally:
        # LOBPCG through the default (exact_columns=False) options
        precond = [0.0]
        t0 = time.perf_counter()
        with timed_solves(precond):
            eig = lobpcg(p, 8, tol=1e-8, options=opts, cache=cache)
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        lap = _laplacian_csr(p).tocsc()
        ref = np.sort(eigsh(lap, k=9, sigma=-1e-2, which="LM",
                            return_eigenvectors=False))[1:]
        eigsh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        unp = lobpcg(p, 8, tol=1e-8, precondition=False,
                     max_iters=eig.iters)
        unp_s = time.perf_counter() - t0
        rel = np.abs(eig.eigenvalues / ref - 1.0)
        say("spectral", step="lobpcg", k=8, tol=1e-8, iters=eig.iters,
            converged=int(eig.converged.sum()),
            precond_solves=eig.precond_solves,
            precond_columns=eig.precond_columns,
            precond_status=eig.precond_status,
            setup_s=round(eig.setup_seconds, 3),
            precond_s=round(precond[0], 3),
            host_algebra_s=round(total - eig.setup_seconds - precond[0], 3),
            eigenvalues=json.dumps(eig.eigenvalues.tolist()),
            eigsh_max_rel_diff=f"{rel.max():.3e}",
            eigsh_s=round(eigsh_s, 1),
            final_residual_max=f"{eig.residual_norms[-1].max():.3e}",
            unpreconditioned_residual_max=(
                f"{unp.residual_norms[-1].max():.3e}"),
            unpreconditioned_converged=int(unp.converged.sum()),
            unpreconditioned_s=round(unp_s, 1), card=smi)
        check(eig.converged.all(), f"lobpcg: {int(eig.converged.sum())} of 8 "
              "pairs converged")
        check(rel.max() <= 1e-6, f"lobpcg eigenvalues vs eigsh: {rel}")

        # Fiedler bisection, clustering and partitioning
        t0 = time.perf_counter()
        mask_s, sweep = fiedler_bisect(p, options=opts, cache=cache)
        mask_n, sign = fiedler_bisect(p, sweep=False, options=opts,
                                      cache=cache)
        clus = spectral_clustering(p, 4, options=opts, cache=cache)
        parts = recursive_bisection(p, 4, options=opts, cache=cache)
        say("spectral", step="cuts", fiedler_value=sweep["fiedler_value"],
            sweep_conductance=sweep["conductance"],
            sign_conductance=sign["conductance"],
            sweep_side=int(mask_s.sum()), sign_side=int(mask_n.sum()),
            clustering_ncut=clus.ncut,
            clustering_conductances=json.dumps(clus.conductances.tolist()),
            clustering_sizes=json.dumps(np.bincount(clus.labels).tolist()),
            bisection_ncut=parts.ncut,
            bisection_conductances=json.dumps(parts.conductances.tolist()),
            bisection_sizes=json.dumps(np.bincount(parts.labels).tolist()),
            seconds=round(time.perf_counter() - t0, 1), card=smi)
        check(sweep["conductance"] <= sign["conductance"] + 1e-12,
              "the sweep cut's conductance is above the sign cut's")
        check(clus.n_clusters == 4 and parts.n_clusters == 4
              and np.isfinite(clus.conductances).all(),
              "clustering or partitioning did not give 4 parts")

        # two positional encodings from one cache: no setup the second time
        pe = []
        for _ in range(2):
            misses, votes = cache.stats()["misses"], phase_launches()
            t0 = time.perf_counter()
            pe.append(laplacian_pe(p, k=8, options=opts, cache=cache,
                                   seed=0))
            pe_s = time.perf_counter() - t0
        new_misses = cache.stats()["misses"] - misses
        new_votes = phase_launches()["agg_vote"] - votes["agg_vote"]
        say("spectral", step="pe", k=8, bitwise=bool(np.array_equal(*pe)),
            second_call_misses=new_misses, second_call_agg_vote=new_votes,
            second_call_s=round(pe_s, 1), card=smi)
        check(np.array_equal(*pe) and new_misses == 0 and new_votes == 0,
              "the second laplacian_pe set up again or differs")

        # the resistance sketch: 64 probes in one blocked solve
        t0 = time.perf_counter()
        sk = effective_resistance(p, n_probes=64, options=opts, cache=cache)
        res_s = time.perf_counter() - t0
        B = _incidence_rhs(p, 64, 0).astype(np.float32)
        rels = host_residual(n, r, c, v, B, sk.Z)
        say("spectral", step="resistance", n_probes=sk.n_probes,
            solve_iters=sk.solve_iters, seconds=round(res_s, 1),
            max_host_f64_rel_residual=f"{rels.max():.3e}", card=smi)
        check((rels <= 1e-4).all(), f"resistance columns above 1e-4: "
              f"{np.flatnonzero(rels > 1e-4).tolist()}")
    launched = phase_launches()
    check(all(launched[k] > 0 for k in ("spmv_ell", "jacobi", "agg_vote"))
          and launched["embedding_bag"] == 0,
          f"spectral phase launches {launched}")
    handle = cache.peek(HierarchyCache.key(p, opts, "single"))
    picks = finest_picks(handle._solver, tally, dict(graph="delaunay"))
    first_vote = max(tally["agg_vote"])
    picks.append(("agg_vote", first_vote, tally["agg_vote"][first_vote],
                  dict(graph="delaunay setup")))
    check_kernel_shapes(torch, "spectral", picks)
    say("spectral", seconds=round(time.perf_counter() - t_phase, 1),
        launches=json.dumps(launched), card=smi)
    return launched


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
    never sync (with and without ``setup_ell_sweeps``), the registry reused,
    batched builds equal to single ones."""
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
    # the same under setup_ell_sweeps: spmv_ell and the spill path inside
    # the agg step (a registry entry of its own, built under the mode too)
    spmvs = launch_counts(SOLVER_KERNELS[:1])[0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ss.build_hierarchy_superstep(adjs[0], dataclasses.replace(
            cfg, setup_ell_sweeps=True))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spmvs = launch_counts(SOLVER_KERNELS[:1])[0] - spmvs

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
        ell_sweeps_no_sync=True, ell_sweeps_spmv_ell_launches=spmvs,
        second_graph_new_entries=new_entries, second_setup_s=round(warm_s, 3),
        batch_bitwise=json.dumps(same),
        batch_registry=registry_line(batch_ledger),
        batch_host_syncs=batch_ledger["host_syncs"])
    check(votes > 0, "the super-step setup launched no agg_vote kernel")
    check(spmvs > 0, "the super-step setup with setup_ell_sweeps launched "
          "no spmv_ell kernel")
    check(new_entries == 0,
          f"a second same-bucket graph added {new_entries} registry entries")
    check(all(same), "batched setups differ from single ones")


def dist_decisions(solver) -> dict:
    """A distributed solver's integer decisions: level kinds and sizes and
    a digest of each level's elimination mask or coarse ids."""
    import hashlib

    from repro_torch.core.elimination import EliminationLevel

    out = dict(kinds=[], sizes=[], ids=[])
    for t in solver.arrays.transfers + solver.coarse_h.transfers:
        elim = isinstance(t, EliminationLevel)
        ids = (t.elim_mask if elim else t.coarse_id).cpu().numpy()
        out["kinds"].append("elim" if elim else "agg")
        out["sizes"].append((t.fine.n, t.coarse.n, t.coarse.adj.nnz))
        out["ids"].append(hashlib.sha256(ids.tobytes()).hexdigest()[:16])
    return out


def dist_child(rank, world_size, graph, device):
    """One rank of phase dist (b): the 2×2 mesh over a gloo group of four
    processes on one card (reductions staged through host memory). Sets
    up and solves the graph, checks the kernels at its block shapes, and
    returns what the parent compares with a world of one."""
    import numpy as np
    import torch

    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import DistLaplacianSolver, make_mesh

    n, r, c, v = graph
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    zero_launches()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[2:]) as votes:
        solver = DistLaplacianSolver.setup(n, r, c, v, mesh,
                                           SetupConfig(matvec_backend="ell"))
    setup_s = time.perf_counter() - t0
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    b -= b.mean()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[:1]) as spmvs:
        X, norms, iters, codes = solver.solve_block(b[:, None], n_iters=200,
                                                    tol=1e-6, guard=True)
    solve_s = time.perf_counter() - t0
    launched = phase_launches()
    # the kernels at this rank's shapes: spmv_ell on each distributed
    # level's block, agg_vote on each row block the setup voted on
    gen = torch.Generator(device=solver.device).manual_seed(3)
    shapes = [tuple(t.fine.ell_col.shape) for t in solver.arrays.transfers]
    picks = [("spmv_ell", shape,
              (spmvs["spmv_ell"].get(shape, [0])[0],
               (t.fine.ell_col, t.fine.ell_val,
                torch.randn(t.fine.n_pad, generator=gen,
                            device=solver.device)), {}),
              dict(rank=rank, block=json.dumps(mesh.block)))
             for shape, t in zip(shapes, solver.arrays.transfers)]
    picks += [("agg_vote", shape, entry,
               dict(rank=rank, block=json.dumps(mesh.block)))
              for shape, entry in sorted(votes["agg_vote"].items())]
    # its lines go back to the parent, which prints them in rank order
    with contextlib.redirect_stdout(io.StringIO()) as lines:
        check_kernel_shapes(torch, "dist", picks)
    return dict(setup_s=setup_s, solve_s=solve_s,
                decisions=dist_decisions(solver), iters=int(iters[0]),
                code=int(codes[0]), x=X[:, 0].cpu().numpy(), b=b,
                launches=launched, stats=mesh.stats(),
                kernels=[(name, shape) for name, shape, _, _ in picks],
                lines=lines.getvalue())


def measure_shape(torch, phase, name, shape, args, kw, calls, unit,
                  **labels) -> None:
    """One kernel at one shape of a phase's own last arguments there:
    ``check_kernel_shapes``'s checks, then both times, the bound and the
    launches per ``unit`` at that shape."""
    check_kernel_shapes(torch, phase, [(name, shape, (calls, args, kw),
                                        labels)])
    run = getattr(importlib.import_module(f"repro_torch.kernels.{name}"),
                  WRAPPERS[f"repro_torch.kernels.{name}"][0])
    n, w = args[0].shape
    b_ms, b_by = bound(*kernel_work(name, args))
    k_ms = time_ms(torch, lambda: run(*args, **kw))
    d_ms, windows = device_ms(torch, lambda: run(*args, **kw), name)
    say(phase, kernel=name, **labels, rows=n, width=w, kernel_ms=k_ms,
        device_ms=d_ms, bound_ms=b_ms, bound_by=b_by,
        of_bound=round(b_ms / d_ms, 4), **{f"launches_per_{unit}": calls},
        profiler_windows=windows)


def mean_free_block(np, n: int, seeds) -> "np.ndarray":
    """The main phase's right-hand sides: one seeded mean-free column a
    seed, as ``phase_main`` makes them."""
    cols = []
    for seed in seeds:
        b = np.random.default_rng(seed).normal(size=n).astype(np.float32)
        b -= b.mean()
        cols.append(b)
    return np.stack(cols, axis=1)


def phase_dist(torch, np, main_graph, main_iters) -> dict:
    """The 2D-distributed solver (``repro_torch.dist``). (a) A world of one
    over NCCL on the main graph: the distributed super-step setup (timed,
    with each distributed level's host partition), its hierarchy bitwise
    the serial super-step's under sync debug ``"error"`` with at most one
    host fetch per constructed level plus 3, four solves through
    ``solve_block`` and through the facade's ``dist`` backend (host
    residual, iterations against the main phase's ``single`` solves,
    guards on/off and a repeat bitwise), all-reduce calls and bytes per
    solve; then every kernel at the distributed path's shapes. (b) A 2×2
    world of four gloo processes on the card on BA 2^18
    (``phase_dist_grid``). Returns each kernel's launches in (a)."""
    from repro_torch.dist import init_world

    t_phase = time.perf_counter()
    mesh = init_world("cuda")
    try:
        launched = phase_dist_one(torch, np, mesh, main_graph, main_iters)
        phase_dist_grid(torch, np, mesh)
    finally:
        torch.distributed.destroy_process_group()
    say("dist", seconds=round(time.perf_counter() - t_phase, 1))
    return launched


def phase_dist_one(torch, np, mesh, main_graph, main_iters) -> dict:
    """Phase dist (a) on the world of one ``mesh``; returns each kernel's
    launches there."""
    from repro_torch.api import Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import (DistLaplacianSolver,
                                  build_hierarchy_superstep_dist)
    from repro_torch.graphs.generators import random_relabel, to_laplacian_coo

    # the communicator starts with the first collective: here, before any
    # check under sync debug mode
    mesh.psum(torch.zeros(1, device=mesh.device))
    torch.cuda.synchronize()
    n, r, c, v = main_graph
    zero_launches()
    ss.clear_cache()
    ss.reset_counters()
    prof = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[2:]) as per_setup:
        solver = DistLaplacianSolver.setup(n, r, c, v, mesh,
                                           SetupConfig(matvec_backend="ell"),
                                           profile=prof)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_votes = launch_counts(SOLVER_KERNELS[2:])[0]
    say("dist", world=f"{mesh.backend} {mesh.shape}", n=n,
        setup_s=round(setup_s, 3), superstep_s=round(prof[0][1], 3),
        partition_s=json.dumps([round(p[2], 3) for p in prof[1:]]),
        setup_agg_vote=setup_votes, setup_allreduce=json.dumps(mesh.stats()))
    for i, m in enumerate(solver.level_meta):
        say("dist", level=i, **dataclasses.asdict(m))
    check(len(solver.level_meta) >= 1, "no level was distributed")
    check(per_setup["agg_vote"], "the distributed setup launched no agg_vote")

    # the hierarchy: the serial super-step's bit for bit, steps that never
    # sync, one host fetch per constructed level
    rr, cc, _, _ = random_relabel(n, r, c, 0)
    adj = to_laplacian_coo(n, rr, cc, v, device=mesh.device)
    ss.clear_cache()
    ss.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h_dist = build_hierarchy_superstep_dist(adj, SetupConfig(), mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fetches = ss.counters()["host_syncs"]
    constructed = len(h_dist.transfers)
    # the dist path's launches so far; the serial build it is held against
    # launches agg_vote too, and those are not counted
    launched = phase_launches()
    h_serial = ss.build_hierarchy_superstep(adj, SetupConfig())
    zero_launches()
    same = bitwise_equal(torch, h_dist, h_serial)
    say("dist", hierarchy_bitwise_serial=same, sync_debug="error",
        host_fetches=fetches, constructed_levels=constructed)
    check(same, "the distributed hierarchy is not the serial super-step's")
    check(fetches <= constructed + 3, f"the distributed setup fetched "
          f"{fetches} times for {constructed} levels")
    del h_dist, h_serial, adj

    B = mean_free_block(np, n, range(100, 100 + DIST_RHS))
    out = {}
    for run in ("guarded", "unguarded", "repeat"):
        mesh.reset_stats()
        with shapes_launched(SOLVER_KERNELS[:2]) as per_solve:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.solve_block(B, n_iters=200, tol=1e-6,
                                     guard=run != "unguarded")
            torch.cuda.synchronize()
        out[run] = (res, (time.perf_counter() - t0) * 1e3, mesh.stats(),
                    per_solve)
    (X, norms, iters, codes), solve_ms, red, per_solve = out["guarded"]
    X = X.cpu().numpy()
    rel = host_residual(n, r, c, v, B, X)
    say("dist", rhs=DIST_RHS, iters=json.dumps(iters.tolist()),
        single_iters=json.dumps(list(main_iters[:DIST_RHS])),
        codes=json.dumps(codes.tolist()), solve_ms=round(solve_ms, 1),
        steps=norms.shape[0] - 1,
        host_f64_rel_residual=json.dumps([f"{x:.3e}" for x in rel]),
        allreduce_calls=red["calls"], allreduce_bytes=red["bytes"],
        launches=json.dumps({k: sum(e[0] for e in t.values())
                             for k, t in per_solve.items()}))
    check((codes == 0).all(), f"a dist solve broke down: codes {codes}")
    check((rel <= 1e-4).all(), f"dist host residuals {rel} > 1e-4")
    diff = [int(a) - int(b) for a, b in zip(iters, main_iters)]
    check(all(abs(d) <= 1 for d in diff), f"dist iterations {iters} vs "
          f"single {main_iters}")
    if any(diff):
        say("dist", iters_differ_from_single_by=json.dumps(diff))
    for run in ("unguarded", "repeat"):
        check(bits_equal(np, out[run][0][0].cpu().numpy(), X)
              and np.array_equal(out[run][0][1], norms),
              f"the {run} dist solve is not bitwise the guarded one")

    # the facade's dist backend on the same mesh: bitwise the direct solve
    t0 = time.perf_counter()
    fs = api_setup(Problem.from_edges(n, r, c, v),
                   SolverOptions(matvec_backend="ell", tol=1e-6),
                   backend="dist", mesh=mesh, cache=False)
    Xf, fres = fs.solve(B)
    facade_s = time.perf_counter() - t0
    say("dist", facade_backend=fs.backend, statuses=json.dumps(
        list(fres.statuses)), iters=json.dumps(fres.iters_per_rhs.tolist()),
        bitwise_direct=bits_equal(np, Xf, X), facade_s=round(facade_s, 2),
        mesh_shape=json.dumps(fs.stats()["mesh_shape"]))
    check(fs.backend == "dist" and fres.status == "converged",
          f"facade dist: {fs.backend} {fres.status}")
    check(bits_equal(np, Xf, X), "the facade's dist solve is not bitwise "
          "the direct solve_block")
    del fs, Xf
    launched = {k: n + launched[k] for k, n in phase_launches().items()}
    check(all(launched[k] > 0 for k in ("spmv_ell", "jacobi", "agg_vote")),
          f"the dist path launched {launched}")

    # every kernel at the distributed path's shapes: spmv_ell on every
    # distributed level's block (the solve runs it on the finest and the
    # aggregation levels; an elimination level below the finest has no
    # SpMV in a V-cycle), jacobi and spmv_ell on the tail, agg_vote on
    # every row block of the setup
    gen = torch.Generator(device=mesh.device).manual_seed(5)
    tally = per_solve["spmv_ell"]
    check(tuple(solver.arrays.fine.ell_col.shape) in tally,
          "spmv_ell did not run on the finest distributed level's block")
    for i, t in enumerate(solver.arrays.transfers):
        lvl = t.fine
        shape = tuple(lvl.ell_col.shape)
        x = torch.randn(lvl.n_pad, generator=gen, device=mesh.device)
        measure_shape(torch, "dist", "spmv_ell", shape,
                      (lvl.ell_col, lvl.ell_val, x), {},
                      tally.get(shape, [0])[0] / DIST_RHS, "solve_column",
                      level=f"distributed {i}")
    dist_shapes = {tuple(t.fine.ell_col.shape)
                   for t in solver.arrays.transfers}
    for name in ("spmv_ell", "jacobi"):
        for shape, (calls, args, kw) in sorted(per_solve[name].items(),
                                               reverse=True):
            if shape not in dist_shapes:
                measure_shape(torch, "dist", name, shape, args, kw,
                              calls / DIST_RHS, "solve_column", level="tail")
    check(len(per_solve["jacobi"]) > 0, "jacobi did not run on the tail")
    for shape, (calls, args, kw) in sorted(per_setup["agg_vote"].items(),
                                           reverse=True):
        measure_shape(torch, "dist", "agg_vote", shape, args, kw, calls,
                      "setup", level="row block")
    return launched


def phase_dist_grid(torch, np, mesh_one) -> None:
    """Phase dist (b): BA 2^18 on a 2×2 mesh of four gloo processes on the
    card (``dist_child``, joined under a timeout), against a world of one
    (this process's NCCL mesh) on the same graph: the same levels and
    integer decisions, equal iterations, host residual ≤ 1e-4, the
    kernels at the 2×2 block shapes in every rank; and the finest level's
    §2.2 balance with random ordering on and off."""
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import (DistLaplacianSolver, balance_report,
                                  partition_edges_2d, run_world)

    n, r, c, v = graph(DIST_GRID_N, seed=0)
    on_card = mesh_one.device.type == "cuda"
    t0 = time.perf_counter()
    ranks = run_world(dist_child, 4,
                      args=((n, r, c, v), str(mesh_one.device)),
                      timeout=DIST_WORLD_TIMEOUT_S,
                      threads=2)
    world_s = time.perf_counter() - t0
    one = DistLaplacianSolver.setup(n, r, c, v, mesh_one,
                                    SetupConfig(matvec_backend="ell"))
    b = ranks[0]["b"]
    _, _, iters1, _ = one.solve_block(b[:, None], n_iters=200, tol=1e-6,
                                      guard=True)
    want = dist_decisions(one)
    rel = host_residual(n, r, c, v, b, ranks[0]["x"])
    say("dist", world="gloo (2, 2)", n=n, world_s=round(world_s, 1),
        setup_s=json.dumps([round(x["setup_s"], 2) for x in ranks]),
        solve_s=json.dumps([round(x["solve_s"], 2) for x in ranks]),
        iters=ranks[0]["iters"], world_of_one_iters=int(iters1[0]),
        host_f64_rel_residual=f"{rel:.3e}",
        levels=json.dumps(want["sizes"]), staged=ranks[0]["stats"]["staged"],
        allreduce_calls=ranks[0]["stats"]["calls"],
        launches=json.dumps(ranks[0]["launches"]))
    for rank, res in enumerate(ranks):
        check(res["decisions"] == want, f"rank {rank}'s levels or integer "
              f"decisions differ from the world of one's")
        check(res["iters"] == int(iters1[0]) and res["code"] == 0,
              f"rank {rank}: {res['iters']} iterations, code {res['code']}, "
              f"world of one {int(iters1[0])}")
        check(bits_equal(np, res["x"], ranks[0]["x"]),
              f"rank {rank}'s x differs from rank 0's")
        # gloo takes host tensors: every reduction of the card's tensors
        # is staged through host memory, and counted
        staged = res["stats"]["calls"] if on_card else 0
        check(res["stats"]["calls"] > 0 and res["stats"]["staged"] == staged,
              f"rank {rank}: {res['stats']}")
        check(all(res["launches"][k] > 0
                  for k in ("spmv_ell", "jacobi", "agg_vote")),
              f"rank {rank} launched {res['launches']}")
        print(res["lines"], end="", flush=True)
        check({k for k, _ in res["kernels"]} == {"spmv_ell", "agg_vote"},
              f"rank {rank} checked {res['kernels']}")
    check(rel <= 1e-4, f"2x2 host residual {rel:.3e} > 1e-4")
    for ordering in (True, False):
        rep = balance_report(partition_edges_2d(n, r, c, v, 2, 2,
                                                random_ordering=ordering))
        say("dist", balance_random_ordering=ordering,
            imbalance=rep["imbalance"], fill_fraction=rep["fill_fraction"],
            max_nnz=rep["max_nnz"], min_nnz=rep["min_nnz"],
            capacity=rep["capacity"])


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
    d_ms, windows = device_ms(torch, fo, "embedding_bag")
    say("kernels", name="embedding_bag", shape="first_order", d=1,
        kernel_ms=time_ms(torch, fo), device_ms=d_ms, bound_ms=b_ms,
        bound_by=b_by, of_bound=round(b_ms / d_ms, 4),
        profiler_windows=windows)
    check(embedding_bag_kernel.launches > before,
          "embedding_bag was not launched in the comparison phase")
    return rec


def main() -> int:
    t_start = time.perf_counter()
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
    main_graph, main_iters = setup["graph"], setup["iters"]
    del setup
    for rec in records:                 # the facade path's own launches
        rec["facade_launches"] = facade[rec["name"]]
    paper = phase_paper(torch, np)
    service = phase_service(torch, np, main_graph, smi)
    spectral = phase_spectral(torch, np, smi)
    phase_e2e(torch, np)
    dist = phase_dist(torch, np, main_graph, main_iters)
    del main_graph
    for rec in records:                 # each later phase's own launches
        rec.update(paper_launches=paper[rec["name"]],
                   service_launches=service[rec["name"]],
                   spectral_launches=spectral[rec["name"]],
                   dist_launches=dist[rec["name"]])
    model, flat, bag_launches = phase_deepfm(torch, np)
    records.append(dict(phase_kernels_deepfm(torch, model, flat,
                                             bag_launches),
                        facade_launches=facade["embedding_bag"],
                        paper_launches=paper["embedding_bag"],
                        service_launches=service["embedding_bag"],
                        spectral_launches=spectral["embedding_bag"],
                        dist_launches=dist["embedding_bag"]))
    say("total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
