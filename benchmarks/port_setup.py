#!/usr/bin/env python3
"""The port's two setup modes on one CUDA card, on the main path's graph.

    python benchmarks/port_setup.py [--logn 16 20] [--seed 1] [--out FILE]

For each size, builds Barabási–Albert n = 2^logn, m = 4 (weighted,
connected, ``--seed``) and its adjacency on the card, then with
``SetupConfig(matvec_backend="ell")``:

* a cold super-step setup (registry cleared) under
  ``torch.cuda.set_sync_debug_mode("error")`` from the plan's start to its
  end: its seconds, its host fetches and registry entries/calls, peak
  device memory, and the error if a step made the host wait;
* a warm super-step setup with ``profile=``: its seconds and each
  constructed level's;
* an eager setup under mode ``"warn"``: its seconds and the host syncs
  PyTorch reported;
* whether the two modes built the same levels (kind, n, nnz).

Prints one JSON object a size (``--out`` also writes them as a list),
each with the card's name and power limit. Needs a CUDA device; imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(torch, logn: int, seed: int) -> dict:
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import (SetupConfig,
                                            build_hierarchy_eager,
                                            hierarchy_stats)
    from repro_torch.graphs.generators import (barabasi_albert,
                                               ensure_connected,
                                               to_laplacian_coo)

    def levels(h):
        return [(row["kind"], row["n"], row["nnz"])
                for row in hierarchy_stats(h)["levels"]]

    n, r, c, v = ensure_connected(*barabasi_albert(1 << logn, m=4, seed=seed,
                                                   weighted=True))
    adj = to_laplacian_coo(n, r, c, v)
    cfg = SetupConfig(matvec_backend="ell")
    out = dict(n=n, nnz=len(r))

    ss.clear_cache()
    ss.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ss.build_hierarchy_superstep(adj, cfg)
        out["sync_error"] = None
    except RuntimeError:
        out["sync_error"] = traceback.format_exc()[-2000:]
        return out
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out.update(cold_s=time.perf_counter() - t0, counters=ss.counters(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    profile: list = []
    t0 = time.perf_counter()
    ss.build_hierarchy_superstep(adj, cfg, profile=profile)
    torch.cuda.synchronize()
    out.update(warm_s=time.perf_counter() - t0, warm_levels=profile)

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            he = build_hierarchy_eager(adj, cfg)
            torch.cuda.synchronize()
            out["eager_s"] = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["eager_host_syncs"] = sum("synchroniz" in str(w.message)
                                  for w in caught)
    out["levels"] = levels(h)
    out["levels_equal"] = levels(h) == levels(he)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logn", type=int, nargs="+", default=[16, 20])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_setup: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = []
    for logn in args.logn:
        res = dict(card=card, **run(torch, logn, args.seed))
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0 if all(r["sync_error"] is None for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
