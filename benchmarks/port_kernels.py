#!/usr/bin/env python3
"""Device time of the port's kernels, for one or more source trees in one
call on one CUDA card.

    python benchmarks/port_kernels.py [--trees SRC [SRC ...]] [--reps 20]
                                      [--out FILE]

Builds the inputs once, with this checkout's port, at the main path's
shapes (those of ``chip_smoke.py``): the main graph's setup (Barabási–
Albert n = 2^20, m = 4, seed 0), then ``spmv_ell`` and ``jacobi`` at every
ELL level where a solve runs them (random x and b from a seeded
generator; the levels are those of one solve, as ``chip_smoke.py``
counts them), ``agg_vote`` at every aggregation level on the arguments of
the setup's last vote there, and ``embedding_bag`` on DeepFM ``FULL``'s
table and first-order weights at the serve_bulk batch (10,223,616 bags,
hot 2). The k-column forms on random row-major blocks: ``spmv_ell_block``
on the main graph's finest table and on its width-8 twin (the setup
sweeps' layout) at k = 8, ``jacobi_block`` on its first aggregation level
at k = 8 (the facade's throughput block of 8), and both at k = 64 on the
finest tables of the spectral phase's graph (Delaunay 2^15, seed 0,
through the spectral layer's default options with the ELL backend).
They are saved under ``build/port_kernels/`` (ignored by git).

Then, for each ``--trees`` entry in order (a directory that holds a
``repro_torch`` package; default: this checkout's ``src``), a child
process imports that tree's wrappers, builds its kernels, and for each
input checks the kernel against its plain version (bitwise equal, or
within rtol 1e-5 / atol 1e-6 for the float ELL kernels; a k-column
form's every column also bitwise the one-vector kernel's) and times it:
``device_ms``, the device time per launch of the one CUDA kernel that
``torch.profiler`` (CUDA activity) sees over ``--reps`` calls (the
wrapper launches nothing else; the mean is over the launches the
profiler saw), and ``kernel_ms``, CUDA events over ``--reps``
back-to-back calls (the wrapper's host time included). Each child builds
its kernels afresh, in a directory of its own, and reports the k-column
kernel instances' registers and spills from ``nvcc -Xptxas -v``
(``block_resources``). A tree given twice runs twice: to compare two
trees on one card, give them in turns (A B B A).

Prints one JSON line per child run, then one summary line: device_ms by
kernel and shape, one column per run. ``--out`` writes all of it as JSON.
Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INPUTS = ROOT / "build" / "port_kernels"


def block_inputs(torch, solver, k, gen, twin=False):
    """The k-column cases at ``solver``'s finest table and first
    aggregation level, on random row-major blocks of ``k`` columns:
    ``(kernel, shape, tensors)`` for ``spmv_ell_block`` on the finest
    table (and on its width-8 twin, the setup sweeps' layout, with
    ``twin``) and ``jacobi_block`` on the first aggregation level."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.graph import attach_setup_twin
    from repro_torch.sparse.ell import ell_layout_traced

    dev = solver.device
    ts = solver.hierarchy.transfers
    fine = ts[0].fine
    agg = next(t for t in ts if isinstance(t, AggregationLevel)).fine
    tables = [fine.ell]
    if twin:
        level = dataclasses.replace(fine, ell=None, ell_rem=None)
        tables.append(attach_setup_twin(level, ell_layout_traced(
            level.adj.row, level.adj.col, level.n, 8)).ell)
    cases = []
    for ell in tables:
        X = torch.randn(ell.n_cols, k, generator=gen, device=dev)
        cases.append(("spmv_ell_block", (*ell.col.shape, k),
                      dict(col=ell.col, val=ell.val, x=X)))
    col, val = agg.ell.col, agg.ell.val
    X, B = (torch.randn(col.shape[0], k, generator=gen, device=dev)
            for _ in range(2))
    cases.append(("jacobi_block", (*col.shape, k),
                  dict(col=col, val=val, x=X, b=B, deg=agg.deg)))
    return cases


def build_inputs(torch) -> None:
    """Make and save the inputs and their index (one entry a case)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import MAIN_N, SOLVER_KERNELS, graph, shapes_launched
    from repro_torch.api import Problem, setup
    from repro_torch.configs.deepfm import FULL, SHAPE_DIMS
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.graphs.generators import delaunay, ensure_connected
    from repro_torch.models.recsys.deepfm import DeepFM, _flat_ids
    from repro_torch.spectral.lobpcg import _default_options

    INPUTS.mkdir(parents=True, exist_ok=True)
    cases = []

    def save(kernel, shape, tensors=None, **kw):
        tensors = dict(tensors or {}, **kw)
        path = INPUTS / f"{kernel}-{'x'.join(map(str, shape))}.pt"
        torch.save({k: v.contiguous() for k, v in tensors.items()}, path)
        cases.append(dict(kernel=kernel, shape=list(shape), file=path.name))

    torch.backends.cuda.matmul.allow_tf32 = False
    n, r, c, v = graph(MAIN_N, seed=0)
    with shapes_launched(SOLVER_KERNELS[2:]) as per_setup:     # agg_vote
        solver = LaplacianSolver.setup(n, r, c, v,
                                       SetupConfig(matvec_backend="ell"))
    rhs = torch.randn(n, generator=torch.Generator().manual_seed(100))
    with shapes_launched(SOLVER_KERNELS[:2]) as per_solve:  # spmv, jacobi
        solver.solve((rhs - rhs.mean()).numpy(), tol=1e-6, maxiter=200)
    gen = torch.Generator(device=solver.device).manual_seed(1)
    ts = solver.hierarchy.transfers
    for level in [t.fine for t in ts] + [ts[-1].coarse]:
        ell = getattr(level, "ell", None)
        if ell is None or ell.width == 0:
            continue
        x = torch.randn(ell.n_cols, generator=gen, device=solver.device)
        b = torch.randn(ell.col.shape[0], generator=gen,
                        device=solver.device)
        if tuple(ell.col.shape) in per_solve["spmv_ell"]:
            save("spmv_ell", ell.col.shape, col=ell.col, val=ell.val, x=x)
        if tuple(ell.col.shape) in per_solve["jacobi"]:
            save("jacobi", ell.col.shape, col=ell.col, val=ell.val, x=x,
                 b=b, deg=level.deg)
    for case in block_inputs(torch, solver, 8, gen, twin=True):
        save(*case)
    for shape, (_, (col, sq, state), kw) in sorted(
            per_setup["agg_vote"].items(), reverse=True):
        save("agg_vote", shape, col=col, sq=sq, state=state,
             levels=torch.tensor(kw["levels"]),
             decided=torch.tensor(kw.get("decided", 0)))
    del solver

    n, r, c, v = ensure_connected(*delaunay(1 << 15, seed=0))
    opts = dataclasses.replace(_default_options(n, None),
                               matvec_backend="ell")
    spectral = setup(Problem.from_edges(n, r, c, v), opts, backend="single",
                     cache=False)
    for case in block_inputs(torch, spectral._handle._solver, 64, gen):
        save(*case)
    del spectral

    dev = torch.device("cuda")
    model = DeepFM(FULL, torch.Generator(device=dev).manual_seed(0))
    bulk = next(recsys_batch_stream(FULL.vocab_per_field,
                                    SHAPE_DIMS["serve_bulk"]["batch"],
                                    FULL.multi_hot, seed=0))[1]
    flat = _flat_ids(FULL, torch.from_numpy(bulk).to(dev)).reshape(
        -1, FULL.multi_hot)
    for t in (model.table.detach(), model.first_order.detach()):
        save("embedding_bag", (*flat.shape, t.shape[1]), table=t, idx=flat)
    (INPUTS / "index.json").write_text(json.dumps(cases))


FLOAT_ELL = ("spmv_ell", "jacobi", "spmv_ell_block", "jacobi_block")


def columns_bitwise(torch, kernel, a, block, spmv_ell, jacobi_step) -> bool:
    """Column j of a k-column result is bitwise the one-vector kernel's
    result on column j of its inputs."""
    for j in range(block.shape[1]):
        x = a["x"][:, j].contiguous()
        one = spmv_ell(a["col"], a["val"], x) if kernel == "spmv_ell_block" \
            else jacobi_step(a["col"], a["val"], x,
                             a["b"][:, j].contiguous(), a["deg"])
        if not torch.equal(block[:, j], one):
            return False
    return True


def block_resources(ptxas: dict) -> list:
    """The registers and spill bytes of each k-column kernel instance
    (``block_tiles_kernel``) in the build's ``nvcc -Xptxas -v`` reports,
    by source: ``[source, symbol, registers, spill stores, spill loads]``
    (the symbol as ``c++filt`` gives it, where it can)."""
    rows, name = [], None
    for src, text in sorted(ptxas.items()):
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1) if "block_tiles_kernel" in m.group(1) \
                    else None
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spills = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                rows.append([src, name, int(m.group(1)), *spills])
                name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r[1] for r in rows), capture_output=True, text=True,
            check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r[1] = n[:160]
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


def device_ms(torch, fn, reps: int) -> tuple[float, str]:
    """Device time per launch of the one CUDA kernel that ``fn`` launches,
    by ``torch.profiler`` over ``reps`` calls, and that kernel's name."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window may record no device activity at all
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in p.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            break
    if len(ev) != 1 or not 0 < ev[0].count <= reps:
        raise RuntimeError("expected one kernel launched once a call, got "
                           + repr([(e.key[:60], e.count) for e in ev]))
    return ev[0].self_device_time_total / 1e3 / ev[0].count, ev[0].key


def child(src: str, reps: int) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms

    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    # a build of its own in every run, so that each reports ptxas's
    # registers and spills (a tree given twice builds twice)
    _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="build-", dir=INPUTS))
    from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref
    from repro_torch.kernels.embedding_bag import (embedding_bag_kernel,
                                                   embedding_bag_ref)
    from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref

    def calls(kernel, a):
        if kernel in ("spmv_ell", "spmv_ell_block"):
            args = (a["col"], a["val"], a["x"])
            return (lambda: spmv_ell(*args)), (lambda: spmv_ell_ref(*args))
        if kernel in ("jacobi", "jacobi_block"):
            args = (a["col"], a["val"], a["x"], a["b"], a["deg"])
            return (lambda: jacobi_step(*args)), \
                (lambda: jacobi_step_ref(*args))
        if kernel == "agg_vote":
            args = (a["col"], a["sq"], a["state"])
            kw = dict(levels=int(a["levels"]), decided=int(a["decided"]))
            return (lambda: vote_reduce(*args, **kw)), \
                (lambda: vote_reduce_ref(*args, **kw))
        args = (a["table"], a["idx"])
        return (lambda: embedding_bag_kernel(*args)), \
            (lambda: embedding_bag_ref(*args))

    rows = []
    for case in json.loads((INPUTS / "index.json").read_text()):
        a = {k: t.cuda() for k, t in torch.load(INPUTS / case["file"]).items()}
        kernel, plain = calls(case["kernel"], a)
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        close = same or (case["kernel"] in FLOAT_ELL and all(
            torch.allclose(g, w, rtol=1e-5, atol=1e-6)
            for g, w in zip(got, want)))
        if case["kernel"].endswith("_block"):     # each column: one vector
            close = close and columns_bitwise(torch, case["kernel"], a,
                                              got[0], spmv_ell, jacobi_step)
        try:
            d_ms, name = device_ms(torch, kernel, reps)
        except RuntimeError as e:
            raise RuntimeError(f"{case['file']}: {e}") from e
        rows.append(dict(case, device_ms=d_ms, kernel_ms=time_ms(
            torch, kernel, reps), bitwise_equal=same, agrees=close,
            symbol=name[:100]))
        del a, got, want
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    print(json.dumps(dict(src=src, device=torch.cuda.get_device_name(0),
                          rows=rows, block_resources=block_resources(
                              _build.build_info.get("ptxas", {})))),
          flush=True)
    return 0 if all(r["agrees"] for r in rows) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=[str(ROOT / "src")])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.reps)
    import torch

    if not torch.cuda.is_available():
        print("port_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    build_inputs(torch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    runs, rc = [], 0
    for src in args.trees:
        p = subprocess.run([sys.executable, __file__, "--child",
                            str(Path(src).resolve()), "--reps",
                            str(args.reps)], capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode not in (0, 1) or not p.stdout.strip():
            print(f"port_kernels: the run on {src} failed", file=sys.stderr)
            return 1
        rc |= p.returncode
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(p.stdout.strip().splitlines()[-1], flush=True)
    summary = {}
    for i, run in enumerate(runs):
        for row in run["rows"]:
            key = f"{row['kernel']} {'x'.join(map(str, row['shape']))}"
            summary.setdefault(key, [None] * len(runs))[i] = row["device_ms"]
    out = dict(card=smi, trees=args.trees, device_ms=summary)
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(out, runs=runs), indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
