#!/usr/bin/env python3
"""Row gathers and segment sums of ``[m, k]`` blocks on one CUDA card:
the plain PyTorch operations around the port's kernels on its throughput
path (``exact_columns=False``: the COO spills, restrictions and
prolongations of ``[n, k]`` blocks).

    python benchmarks/port_gather.py [--n 1048576] [--m 2500000]
                                     [--ks 1 3 4 8 16 32 64 128] [--out FILE]

For each width k, on a seeded ``[n, k]`` float32 block and ``m`` random
row ids (the scale of the main path's spills, BA 2^20): CUDA-event ms of
``index_select`` along dim 0, ``torch.gather`` with the ids expanded,
advanced indexing, the flat form the port takes for rows of 16 to 256
bytes (``sparse.segment.take_rows``: one 1-D ``index_select`` over the
elements, its index built in the call), and ``segment_reduce`` over the
ids sorted into ``n`` segments on the ``[m, k]`` block, on its transpose
(``axis=1``) and, for k ≤ 8, on each 1-D column in turn (``torch``'s
1-D path is CUB's segmented reduce); with whether each form's values are
equal. Prints one JSON line a width and the card's name and power limit.
Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def time_ms(torch, fn, reps: int = 20) -> float:
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


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.sparse.segment import take_rows

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--m", type=int, default=2_500_000)
    ap.add_argument("--ks", type=int, nargs="+",
                    default=[1, 3, 4, 8, 16, 32, 64, 128])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_gather: needs a CUDA device", file=sys.stderr)
        return 2
    dev = "cuda"
    n, m = args.n, args.m
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, n, (m,), generator=gen, device=dev)
    seg = torch.sort(idx).values
    bounds = torch.searchsorted(seg, torch.arange(n + 1, device=dev))
    lengths = bounds[1:] - bounds[:-1]
    rows = []
    for k in args.ks:
        x = torch.randn(n, k, generator=gen, device=dev)
        want = x.index_select(0, idx)
        wide = idx[:, None].expand(m, k)
        r = dict(k=k, n=n, m=m,
                 index_select=time_ms(torch, lambda: x.index_select(0, idx)),
                 gather=time_ms(torch, lambda: torch.gather(x, 0, wide)),
                 advanced_index=time_ms(torch, lambda: x[idx]),
                 take_rows=time_ms(torch, lambda: take_rows(x, idx)),
                 equal=bool(torch.equal(torch.gather(x, 0, wide), want)
                            and torch.equal(x[idx], want)
                            and torch.equal(take_rows(x, idx), want)))
        d = torch.randn(m, k, generator=gen, device=dev)
        r["segment_reduce"] = time_ms(torch, lambda: torch.segment_reduce(
            d, "sum", lengths=lengths, axis=0, unsafe=True))
        dt = d.t().contiguous()
        lk = lengths[None, :].expand(k, n).contiguous()
        r["segment_reduce_transposed"] = time_ms(
            torch, lambda: torch.segment_reduce(dt, "sum", lengths=lk,
                                                axis=1, unsafe=True))
        s2 = torch.segment_reduce(d, "sum", lengths=lengths, axis=0,
                                  unsafe=True)
        r["transposed_equal"] = bool(torch.equal(s2, torch.segment_reduce(
            dt, "sum", lengths=lk, axis=1, unsafe=True).t()))
        if k <= 8:
            cols = [d[:, j].contiguous() for j in range(k)]
            r["segment_reduce_1d_columns"] = time_ms(torch, lambda: [
                torch.segment_reduce(c, "sum", lengths=lengths, axis=0,
                                     unsafe=True) for c in cols])
            r["1d_columns_equal"] = bool(all(torch.equal(
                torch.segment_reduce(c, "sum", lengths=lengths, axis=0,
                                     unsafe=True), s2[:, j])
                for j, c in enumerate(cols)))
        rows.append(r)
        print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=smi, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
