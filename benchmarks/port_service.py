#!/usr/bin/env python3
"""The port's serving layer on one CUDA card: setups per second batched
against looped, and request latency.

    python benchmarks/port_service.py [--n 262144] [--graphs 8]
                                      [--batches 1 2 4 8] [--device cuda]
                                      [--out FILE]

The port's counterpart of ``benchmarks/service_bench.py``, at the graphs
of ``chip_smoke.py``'s ``service`` phase: ``--graphs`` Barabási–Albert
graphs of ``--n`` vertices (m = 4, seeds 1, 2, ..., weighted, made
connected), all in one bucket signature, generated in parallel processes.

* **Setups per second.** For each ``max_batch`` of ``--batches``, a fresh
  ``SolverService`` (``SolverOptions(matvec_backend="ell", tol=1e-6)``,
  its own hierarchy cache) takes one k = 1 request per graph and flushes
  once; its setup pass's wall seconds (``stats()["setup_seconds"]``, host
  work included, the setup registry warm) give setups/s. Each
  ``max_batch`` runs once untimed to warm its registry entries, then the
  timed runs go in turns, ascending then descending, and the row keeps
  both. ``max_batch=1`` is the looped setup. The reference's
  ``BENCH_service.json`` claims batched ≥ 2× looped from a *modelled*
  parallel time on the CPU; here the ratio is the card's measured wall
  time.
* **Stages.** The host preparation of the graphs, then the group's
  hierarchy builds stacked against looped, warm and in turns (where a
  batched setup's time goes: the stacked steps speed only the builds).
* **Request latency.** The ``service`` phase's stream (per graph k = 1
  and k = 4 at tol 1e-6, k = 8 at tol 1e-8 with ``max_iters=100``)
  through a service with ``max_batch=8`` and ``verify="cheap"``: one cold
  flush (setups included) and one warm flush (every lookup a cache hit),
  each with ``stats()``'s latency percentiles (submit to the flush's
  return), solve seconds per right-hand-side column and the peak device
  memory.

Prints one JSON object per measurement with the card's name and power
limit (``--out`` also writes them as a list). ``--device cpu`` runs the
same on the CPU at a small ``--n``. Imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ba_graph(args):
    n, seed = args
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    return ensure_connected(*barabasi_albert(n, m=4, seed=seed,
                                             weighted=True))


def ba_graphs(n: int, seeds, workers: int = 8) -> list:
    """``ensure_connected(barabasi_albert(n, m=4, seed, weighted=True))``
    for each seed, generated in parallel ``spawn`` processes (host numpy
    only; the pool is closed before this returns)."""
    seeds = list(seeds)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, len(seeds))) as pool:
        return pool.map(_ba_graph, [(n, s) for s in seeds])


def stream(problems, seed: int = 0) -> list:
    """The ``service`` phase's requests on ``problems``: per problem
    ``(index, B, kw)`` for k = 1 and k = 4 at the service's tol, and k = 8
    at tol 1e-8 with ``max_iters=100``; seeded mean-free float32
    right-hand sides."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(problems):
        for k, kw in ((1, {}), (4, {}), (8, dict(tol=1e-8, max_iters=100))):
            B = rng.normal(size=(p.n, k)).astype(np.float32)
            B -= B.mean(axis=0)
            out.append((i, B[:, 0] if k == 1 else B, kw))
    return out


def setups_per_s(torch, problems, max_batch: int, device) -> dict:
    """One flush of one k = 1 request per problem through a fresh service:
    the setup pass's wall seconds and its batching counters."""
    import numpy as np

    from repro_torch.api import SolverOptions
    from repro_torch.service import SolverService

    svc = SolverService(SolverOptions(matvec_backend="ell", tol=1e-6,
                                      device=device),
                        backend="single", max_batch=max_batch)
    for p in problems:
        b = np.zeros(p.n, np.float32)
        b[0], b[-1] = 1.0, -1.0
        svc.submit(p, b)
    svc.flush()
    st = svc.stats()
    return dict(max_batch=max_batch, setups=len(problems),
                setup_s=st["setup_seconds"],
                setups_per_s=len(problems) / st["setup_seconds"],
                setup_batches=st["setup_batches"],
                setups_batched=st["setups_batched"],
                setups_looped=st["setups_looped"])


def stages(torch, problems, device) -> dict:
    """Where a batched setup's time goes, at the service's setup
    configuration: the host preparation of every graph (relabelling,
    components, the padded adjacency on the device: the same work batched
    or looped), then the group's hierarchy builds, stacked
    (``build_hierarchy_superstep_batch``: one stacked step a level round,
    one graph-batched vote launch a round) and looped
    (``build_hierarchy_superstep`` a graph), warm, in turns stacked,
    looped, looped, stacked; with each build's registry calls, host
    fetches and vote launches."""
    from repro_torch.api import SolverOptions
    from repro_torch.core import setup_step as ss
    from repro_torch.core.solver import _prepare
    from repro_torch.kernels.agg_vote import ops

    dev = torch.device(device)
    cfg = SolverOptions(matvec_backend="ell", tol=1e-6,
                        device=device).setup_config()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    adjs = [_prepare(p.n, p.rows, p.cols, p.vals, cfg.seed, True, None,
                     dev)[1] for p in problems]
    sync()
    prep_s = time.perf_counter() - t0
    runs = dict(stacked=lambda: ss.build_hierarchy_superstep_batch(adjs, cfg),
                looped=lambda: [ss.build_hierarchy_superstep(a, cfg)
                                for a in adjs])
    for run in runs.values():             # warm the registry
        run()
    seconds, counts = {k: [] for k in runs}, {}
    for name in ("stacked", "looped", "looped", "stacked"):
        sync()
        v0 = (ops.vote_reduce.launches, ops.vote_reduce_batched.launches)
        ss.reset_counters()
        t0 = time.perf_counter()
        runs[name]()
        sync()
        seconds[name].append(time.perf_counter() - t0)
        ledger = ss.counters()
        counts[name] = dict(
            step_calls={k: v["calls"] for k, v in ledger["steps"].items()},
            host_syncs=ledger["host_syncs"],
            vote_launches=ops.vote_reduce.launches - v0[0],
            vote_batched_launches=ops.vote_reduce_batched.launches - v0[1])
    return dict(graphs=len(problems), prep_s=prep_s,
                stacked_s=seconds["stacked"], looped_s=seconds["looped"],
                stacked=counts["stacked"], looped=counts["looped"])


def latency(torch, problems, device) -> list:
    """The phase's stream through a ``max_batch=8`` service (cold: setups
    included) and then through a second one on the same hierarchy cache
    (warm: every lookup a hit): latency percentiles, solve seconds per
    column, peak memory."""
    from repro_torch.api import SolverOptions
    from repro_torch.service import SolverService

    on_card = torch.device(device).type == "cuda"
    opts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="cheap",
                         device=device)
    rows, cache = [], None
    for run in ("cold", "warm"):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        svc = SolverService(opts, backend="single", max_batch=8, cache=cache)
        cache = svc.cache
        t0 = time.perf_counter()
        tickets = [svc.submit(problems[i], B, **kw)
                   for i, B, kw in stream(problems)]
        svc.flush()
        wall = time.perf_counter() - t0
        st = svc.stats()
        rows.append(dict(
            run=run, requests=len(tickets), rhs_columns=st["rhs_columns"],
            flush_s=wall, setup_s=st["setup_seconds"],
            solve_s_per_column=st["solve_seconds"] / st["rhs_columns"],
            latency_seconds=st["latency_seconds"],
            statuses=sorted({t.result()[1].status for t in tickets}),
            cache=st["cache"],
            peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if on_card else None)))
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--graphs", type=int, default=8)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    card = "cpu"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("port_service: needs a CUDA device", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        _build.library()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    from repro_torch.api import Problem

    t0 = time.perf_counter()
    graphs = ba_graphs(args.n, range(1, args.graphs + 1))
    problems = [Problem.from_edges(*g) for g in graphs]
    for p in problems:
        p.fingerprint()
    sigs = {p.bucket_signature() for p in problems}
    rows = [dict(card=card, step="graphs", n=args.n, graphs=len(problems),
                 bucket_signatures=sorted(sigs),
                 generate_s=time.perf_counter() - t0)]
    print(json.dumps(rows[-1]), flush=True)
    for mb in args.batches:                # warm each batch's entries
        setups_per_s(torch, problems, mb, args.device)
    timed = {mb: [] for mb in args.batches}
    for mb in [*args.batches, *reversed(args.batches)]:
        timed[mb].append(setups_per_s(torch, problems, mb, args.device))
    looped = [r["setup_s"] for r in timed.get(1, [])]
    for mb, runs in timed.items():
        row = dict(card=card, step="setups", max_batch=mb,
                   setups_per_s=[r["setups_per_s"] for r in runs],
                   setup_s=[r["setup_s"] for r in runs],
                   setup_batches=runs[0]["setup_batches"],
                   setups_batched=runs[0]["setups_batched"],
                   setups_looped=runs[0]["setups_looped"])
        if looped:
            row["speedup_vs_looped"] = [a / r["setup_s"]
                                        for a, r in zip(looped, runs)]
        rows.append(row)
        print(json.dumps(row), flush=True)
    rows.append(dict(card=card, step="stages",
                     **stages(torch, problems, args.device)))
    print(json.dumps(rows[-1]), flush=True)
    for row in latency(torch, problems, args.device):
        rows.append(dict(card=card, step="latency", **row))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
