"""Where the time of setup and of a solve goes on the card.

    python -m repro_torch.trace_solve [--n 1048576] [--trace PATH] [--block K]
    python -m repro_torch.trace_solve --batch 8 [--batch-n 131072]

Builds the main path's graph (Barabási–Albert, m = 4, seed 0, weighted,
connected) and:

* times ``LaplacianSolver.setup`` (the super-step setup) per stage with
  ``cProfile``; the stages' host reads, and the super-step's fetches
  (``_fetch``), wait for the device, so a stage's wall time holds the
  device work queued before its next wait. Then a second, warm super-step
  build of the same adjacency with ``profile=``: the seconds of each
  constructed level (each level ends in a device wait), its host fetches
  and its registry entries/calls; then a warm eager build of it;
* times one warm solve (tol 1e-6) untraced, then traces the same solve
  with ``torch.profiler``: device time by kernel name, and the device's
  busy share against the untraced wall time (the profiler's own host
  overhead stretches the traced solve's wall time, so the share against
  that is reported too, as a lower bound), and each of the port's own
  kernels' device time and launches. The port runs on one stream, so
  kernel times add up. ``--trace`` writes the Chrome trace;
* with ``--block K``, traces one warm blocked solve of K right-hand
  sides on the throughput path (``exact_columns=False``: one k-column
  ``spmv_ell``/``jacobi`` launch a level operation) the same way, its
  kernels grouped by kernel and form (``spmv_ell_block``,
  ``jacobi_block``);
* with ``--batch G`` (instead of all the above), traces the batched
  setup of G Barabási–Albert graphs of ``--batch-n`` vertices (m = 4,
  seeds 1..G, the service phase's graphs) the same way, warm: their
  hierarchy builds stacked (``build_hierarchy_superstep_batch``) and
  looped (``build_hierarchy_superstep`` a graph), each with its device
  busy time, launches and top kernels.

Prints one JSON object. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import time

SETUP_STAGES = (
    "random_relabel", "connected_components", "to_laplacian_coo",
    "select_eliminated", "schur_arrays", "algebraic_distance_strength",
    "ell_layout_traced", "aggregate", "renumber_device", "contract_arrays",
    "estimate_lambda_max", "_fetch", "coarse_inverse",
    "attach_ell_transfers")


def _stage_seconds(prof: cProfile.Profile) -> dict:
    """Cumulative wall seconds of each setup stage function (first call
    site by name; recursive or repeated calls are summed by cProfile)."""
    out = {}
    for (filename, _, name), row in pstats.Stats(prof).stats.items():
        if name in SETUP_STAGES and "repro_torch" in filename.replace("\\", "/"):
            out[name] = out.get(name, 0.0) + row[3]
    return {k: round(out[k], 3) for k in SETUP_STAGES if k in out}


# the port's own kernels, by a part of the name the profiler reports; a
# kernel of several device kernels has a part each, its first part
# launched once a call: the bag backward's two passes, and its plan's key
# pass and the radix sort's kernels (CUB compiled under the namespace
# repro_bag_plan: a histogram, a scan and a pass per 8 bits of the keys)
PORT_KERNELS = {"StoreRow": "spmv_ell", "JacobiRow": "jacobi",
                "StoreBlock": "spmv_ell_block", "JacobiBlock": "jacobi_block",
                "VoteRow": "agg_vote", "StackedVote": "agg_vote_batched",
                "bag_tiles_kernel": "embedding_bag",
                "bag_rows_gather": "embedding_bag",
                "bag_grad_chunks": "embedding_bag_backward",
                "bag_grad_finish": "embedding_bag_backward",
                "bag_rows_sums": "embedding_bag_backward",
                "bag_rows_finish": "embedding_bag_backward",
                "bag_grad_keys": "bag_grad_plan",
                "repro_bag_plan::": "bag_grad_plan"}
# a launch of a kernel runs the parts of one of its paths (the bag
# kernels' narrow and wide paths, kernels.bag_path); a kernel not listed
# here has a path of each part alone
_PATHS = {"embedding_bag_backward": (("bag_grad_chunks", "bag_grad_finish"),
                                     ("bag_rows_sums", "bag_rows_finish")),
          "bag_grad_plan": (("bag_grad_keys", "repro_bag_plan::"),)}


def kernel_paths(kernel: str) -> tuple:
    """The paths of the port's kernel ``kernel`` (a value of
    ``PORT_KERNELS``): tuples of parts, the device kernels one launch
    runs, its first part launched once a call."""
    parts = tuple(p for p, name in PORT_KERNELS.items() if name == kernel)
    if not parts:
        raise ValueError(f"kernel_paths: unknown kernel {kernel!r}")
    return _PATHS.get(kernel, tuple((p,) for p in parts))


def kernel_device_ms(torch, fn, kernel: str, reps: int = 20):
    """The device time of one launch of the port's kernel ``kernel`` (a
    value of ``PORT_KERNELS``) in ``fn``: three warm-up calls, then
    ``reps`` calls under ``torch.profiler`` (CUDA activity only: on an
    H100, windows that also traced the CPU lost their device events about
    once in a hundred, CUDA-only ones none in 450); the kernel's self
    device time there over its launches, in ms, and the number of
    launches the profiler saw, and the windows profiled. The profiler can
    drop some or all of a window's launches (on an H100, once all of them
    in three windows in a row), so a window that saw no launch is
    profiled again, up to ten in all; ``(nan, 0, 10)`` means none saw
    one. For a kernel of several device kernels (parts), a window must see
    every part of one of its paths (:func:`kernel_paths`); the launches
    are those of the path's first part, and one launch's time is the sum
    over the path's parts of each part's mean time per device kernel
    times its device kernels per launch (its count over the first part's,
    rounded)."""
    from torch.profiler import ProfilerActivity, profile

    paths = kernel_paths(kernel)
    parts = [part for path in paths for part in path]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for window in range(1, 11):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {part: (0, 0.0) for part in parts}
        for e in p.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for part in parts:
                if part in e.key:
                    count, us = seen[part]
                    seen[part] = (count + e.count,
                                  us + e.self_device_time_total)
        for path in paths:
            count = seen[path[0]][0]
            if all(seen[part][0] for part in path):
                ms = sum(us / c * max(1, round(c / count))
                         for c, us in (seen[part] for part in path)) / 1e3
                return ms, count, window
    return float("nan"), 0, window


def profile_call(torch, fn, trace_path=None, top: int = 10):
    """Run ``fn`` once to warm up, once untraced (host clock, ending in a
    synchronise) and once under ``torch.profiler``. Returns the traced
    call's result and its device time: busy ms by kernel name (the port
    runs on one stream, so kernel times add up), the busy share against
    the untraced wall time and, as a lower bound, against the traced one,
    which the profiler's own host overhead stretches; the device time and
    launches of each of the port's kernels (all its instantiations and
    parts together; a launch of a kernel of two parts counts once);
    ``trace_path`` writes the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in p.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if trace_path:
        p.export_chrome_trace(trace_path)
    port = {}
    for e in kernels:
        for part, name in PORT_KERNELS.items():
            if part in e.key:
                parts = port.setdefault(name, {})
                count, us = parts.get(part, (0, 0))
                parts[part] = (count + e.count,
                               us + e.self_device_time_total)
    # launches of a kernel of several parts: those of each path's first
    port = {name: (sum(parts.get(path[0], (0, 0))[0]
                       for path in kernel_paths(name)),
                   sum(us for _, us in parts.values()))
            for name, parts in port.items()}
    return out, dict(
        untraced_ms=round(untraced_ms, 3), traced_ms=round(wall_ms, 3),
        device_busy_ms=round(busy_ms, 3),
        device_busy_share=round(busy_ms / untraced_ms, 4),
        device_busy_share_of_traced=round(busy_ms / wall_ms, 4),
        kernel_launches=int(sum(e.count for e in kernels)),
        port_kernels={name: dict(count=c, ms=round(us / 1e3, 4))
                      for name, (c, us) in port.items()},
        top_kernels=[dict(name=e.key[:80], count=e.count,
                          ms=round(e.self_device_time_total / 1e3, 4))
                     for e in sorted(kernels,
                                     key=lambda e: -e.self_device_time_total)
                     [:top]])


def trace_batch(torch, n_graphs: int, n: int, cfg) -> dict:
    """The ``--batch`` trace: G graphs' hierarchy builds, stacked and
    looped, each through :func:`profile_call` (warm)."""
    from repro_torch.core import setup_step
    from repro_torch.core.solver import _prepare
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    adjs = [_prepare(*ensure_connected(*barabasi_albert(
        n, m=4, seed=seed, weighted=True)), cfg.seed, True, None,
        torch.device("cuda"))[1] for seed in range(1, n_graphs + 1)]
    runs = dict(
        stacked=lambda: setup_step.build_hierarchy_superstep_batch(adjs, cfg),
        looped=lambda: [setup_step.build_hierarchy_superstep(a, cfg)
                        for a in adjs])
    out = dict(device=torch.cuda.get_device_name(0), batch_graphs=n_graphs,
               batch_n=n)
    for name, run in runs.items():
        _, prof = profile_call(torch, run, top=12)
        out.update({f"{name}_{k}": val for k, val in prof.items()})
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch.core import setup_step
    from repro_torch.core.hierarchy import SetupConfig, build_hierarchy_eager
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--trace", default=None, help="Chrome trace output path")
    ap.add_argument("--block", type=int, default=0,
                    help="also trace a blocked solve of this many columns")
    ap.add_argument("--batch", type=int, default=0,
                    help="trace only the batched setup of this many graphs")
    ap.add_argument("--batch-n", type=int, default=1 << 17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_solve: needs a CUDA device", file=sys.stderr)
        return 2

    # the coarse solve's dense product in full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.batch:
        print(json.dumps(trace_batch(torch, args.batch, args.batch_n,
                                     SetupConfig(matvec_backend="ell"))))
        return 0
    n, r, c, v = ensure_connected(*barabasi_albert(args.n, m=4, seed=0,
                                                   weighted=True))
    cfg = SetupConfig(matvec_backend="ell")
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    solver = LaplacianSolver.setup(n, r, c, v, cfg)
    torch.cuda.synchronize()
    prof.disable()
    setup_s = time.perf_counter() - t0
    levels: list = []
    setup_step.reset_counters()
    t0 = time.perf_counter()
    adj = solver.hierarchy.transfers[0].fine.adj       # the input, as is
    setup_step.build_hierarchy_superstep(adj, cfg, profile=levels)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ledger = setup_step.counters()
    t0 = time.perf_counter()
    build_hierarchy_eager(adj, cfg)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0

    b = np.random.default_rng(100).normal(size=n).astype(np.float32)
    b -= b.mean()
    (_, info), prof_solve = profile_call(
        torch, lambda: solver.solve(b, tol=1e-6), args.trace, top=12)
    block = {}
    if args.block:
        B = np.random.default_rng(200).normal(size=(n, args.block)).astype(
            np.float32)
        B -= B.mean(axis=0)
        (_, binfo), prof_block = profile_call(
            torch, lambda: solver.solve_block(B, tol=1e-6,
                                              exact_columns=False), top=12)
        block = dict(block_k=args.block,
                     block_iters=binfo.iters.tolist(),
                     **{f"block_{k}": val for k, val in prof_block.items()})
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), n=n, nnz=len(r),
        setup_s=round(setup_s, 3), setup_stage_s=_stage_seconds(prof),
        superstep_warm_s=round(warm_s, 3), eager_warm_s=round(eager_s, 3),
        superstep_level_s=[[k, n_fine, round(sec, 4)]
                           for k, n_fine, sec in levels],
        superstep_host_syncs=ledger["host_syncs"],
        superstep_registry={k: f"{st['compiles']}/{st['calls']}"
                            for k, st in ledger["steps"].items()},
        solve_iters=info.iters,
        **{f"solve_{k}": val for k, val in prof_solve.items()}, **block)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
