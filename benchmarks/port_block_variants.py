#!/usr/bin/env python3
"""Design variants of the ELL kernels' k-column form, timed in turns on one
CUDA card.

    python benchmarks/port_block_variants.py [--reps 50] [--out FILE]

Each variant is this checkout's ``src/repro_torch/csrc`` with a few text
edits (``VARIANTS``: the L2 policies of the gathers, the stores and the
reads of B turned off one at a time and together) or with another tile
plan (``PLANS``: one unit a thread in place of two; two stages fixed).
Every variant is built with ``nvcc`` into ``build/port_block_variants/``
(ignored by git), all builds started together, and called through
``ctypes`` on the same inputs: random ELL tables with Poisson(8) (12 at
width 34, 6 at width 8) real slots a row at uniform random columns and
random blocks, at the main path's shapes (1,048,576 × 19 and its width-8
twin, 699,024 × 34) at k = 8 and 4 and the spectral mesh's (32,768 × 8,
29,103 × 8) at k = 64. Column 0 of the first variant is checked bitwise
against the one-vector kernel, and every variant bitwise against the
first. Times are CUDA events over ``--reps`` launches after a warm-up,
each variant in two rounds (forward, then backward). A text edit that no
longer matches the source is an error, not a skipped variant.

Prints the card, then one line per shape: ms by variant. Needs a CUDA
device and ``nvcc``; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "port_block_variants"

_H, _B = "ell_tiles.cuh", "bulk_copy.cuh"
_NORMAL_GATHERS = (_B, "createpolicy.fractional.L2::evict_last.b64",
                   "createpolicy.fractional.L2::evict_normal.b64")
_PLAIN_STORES = (
    (_H, "__stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], "
         "o[2], o[3]));",
     "*reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);"),
    (_H, "__stcs(reinterpret_cast<float2*>(p), make_float2(o[0], o[1]));",
     "*reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);"),
    (_H, "__stcs(p, o[0]);", "p[0] = o[0];"))
_CACHED_B = (_H, "__ldcs(reinterpret_cast<const float4*>(p))",
             "__ldg(reinterpret_cast<const float4*>(p))")
# name -> the text edits of the sources
VARIANTS = {
    "as_is": (),
    "gathers_evict_normal": (_NORMAL_GATHERS,),
    "plain_stores": _PLAIN_STORES,
    "no_policies": (_NORMAL_GATHERS, *_PLAIN_STORES, _CACHED_B),
}
# name -> changes to the tile plan, on the sources as they are
PLANS = {"one_unit_a_thread": dict(rows_mul=1), "two_stages": dict(stages=2)}
SHAPES = ((1 << 20, 19, 8, "spmv", 8), (1 << 20, 8, 8, "spmv", 6),
          (699024, 34, 8, "jacobi", 12), (1 << 20, 19, 4, "spmv", 8),
          (699024, 34, 4, "jacobi", 12), (32768, 8, 64, "spmv", 6),
          (29103, 8, 64, "jacobi", 6))


def plan(width, k, rows_mul=2, stages=None):
    """``repro_torch.kernels.ell_block_tile_plan`` with its two units a
    thread (``rows_mul``) and its stages as parameters."""
    from repro_torch.kernels import SMEM_PER_BLOCK, ell_lanes

    cols = 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1
    T = max(1, ell_lanes(width) * cols // 16)
    h = (k // cols) * T
    rows = max(4, min(rows_mul * (256 // h),
                      32768 // (8 * max(width, 1))) // 4 * 4)
    threads = min(256, -(-rows * h // 32) * 32)
    tile = 8 * rows * width
    stages = stages or min(8, max(2, -(-16384 // max(tile, 1))))
    if width == 0 or 2 * tile > SMEM_PER_BLOCK:
        return rows, 0, 0, cols, T, threads
    return rows, stages, stages * tile, cols, T, threads


def build(name, edits):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for f, old, new in edits:
        text = (d / f).read_text()
        if old not in text:
            raise ValueError(f"{name}: {f} no longer holds {old[:60]!r}")
        (d / f).write_text(text.replace(old, new))
    return subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode",
         "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared", str(d / "spmv_ell.cu"), str(d / "jacobi.cu"),
         "-o", str(d / "lib.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(path))
    for fn, args in (("repro_spmv_ell_block_f32", [P] * 4 + [I] * 10 + [P]),
                     ("repro_jacobi_block_f32",
                      [P] * 6 + [I] * 3 + [F] + [I] * 6 + [P]),
                     ("repro_spmv_ell_f32", [P] * 4 + [I] * 6 + [P])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("port_block_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ell_tile_plan

    procs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(f"port_block_variants: {name} failed to build:\n{log}",
                  file=sys.stderr)
            return 1
    libs = {name: bind(OUT / name / "lib.so") for name in VARIANTS}
    runs = [(name, name, {}) for name in VARIANTS] + \
        [(name, "as_is", kw) for name, kw in PLANS.items()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    table, ok = {}, True
    for n, w, k, kind, mean in SHAPES:
        real = np.minimum(rng.poisson(mean, n), w)
        col = rng.integers(0, n, (n, w)).astype(np.int32)
        val = rng.normal(size=(n, w)).astype(np.float32)
        pad = np.arange(w)[None, :] >= real[:, None]
        col[pad], val[pad] = n, 0
        C, V = torch.from_numpy(col).cuda(), torch.from_numpy(val).cuda()
        X, B = (torch.randn(n, k, device="cuda") for _ in range(2))
        deg = torch.rand(n, device="cuda") * w + 0.5
        Y = torch.empty(n, k, device="cuda")
        key = f"{kind}_block {n}x{w}x{k}"
        times, first = {}, None
        for rnd in range(2):
            for name, lib_name, kw in (runs if rnd == 0 else runs[::-1]):
                lib, pl = libs[lib_name], plan(w, k, **kw)
                if kind == "spmv":
                    call = lambda: lib.repro_spmv_ell_block_f32(  # noqa: E731
                        C.data_ptr(), V.data_ptr(), X.data_ptr(),
                        Y.data_ptr(), n, w, n, k, *pl, stream)
                else:
                    call = lambda: lib.repro_jacobi_block_f32(  # noqa: E731
                        C.data_ptr(), V.data_ptr(), X.data_ptr(),
                        B.data_ptr(), deg.data_ptr(), Y.data_ptr(), n, w, k,
                        2.0 / 3.0, *pl, stream)
                if call() != 0:
                    raise RuntimeError(f"{key} {name}: launch failed")
                torch.cuda.synchronize()
                if first is None:
                    first = Y.clone()
                    if kind == "spmv":            # column 0: one vector
                        y1, x0 = torch.empty(n, device="cuda"), X[:, 0].clone()
                        lib.repro_spmv_ell_f32(
                            C.data_ptr(), V.data_ptr(), x0.data_ptr(),
                            y1.data_ptr(), n, w, n, *ell_tile_plan(w), stream)
                        torch.cuda.synchronize()
                        ok &= torch.equal(y1, first[:, 0])
                ok &= torch.equal(Y, first)
                for _ in range(5):
                    call()
                start.record()
                for _ in range(args.reps):
                    call()
                end.record()
                torch.cuda.synchronize()
                times.setdefault(name, []).append(
                    round(start.elapsed_time(end) / args.reps, 5))
        table[key] = times
        print(key, " ".join(f"{name}={t}" for name, t in times.items()),
              flush=True)
    print(json.dumps(dict(bitwise=bool(ok))), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=smi, reps=args.reps, ms=table, bitwise=bool(ok)),
            indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
