"""Multi-pod dry-run: torch port of ``repro.launch.dryrun``.

For every (architecture × input shape) cell, trace the step once as rank
0 of the production mesh — 16×16 single-pod AND 2×16×16 multi-pod, a fake
process group of 256 or 512 ranks (``launch.mesh``) — and record one
rank's memory, FLOPs, bytes and collective traffic with the H100 roofline
terms (``launch.cost``). The model steps run on fake tensors: DTensors
whose local shards are placed by the reference's spec tables
(``models.sharding``) and never allocated. The solver's step runs rank
0's program for real (``configs.laplacian_solver``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepfm \
      --shape train_batch
  ... --device cpu          (on the CPU; the default is the CUDA card)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary
Results land in experiments/dryrun_torch/*.json; ``--summary`` prints them
as one markdown table.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import SkipCell, get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch import cost
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.models.sharding import local_shape_offset
from repro_torch.tree import tree_map

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def local_shape(spec, sharding) -> tuple:
    """This rank's shape of an argument leaf (``TensorSpec``) placed by a
    ``NamedSharding`` (DTensor's split: the first ranks take the larger
    chunks)."""
    return local_shape_offset(spec.shape, sharding.mesh,
                              sharding.placements)[0]


def materialize(specs, shardings, device):
    """DTensors of ``specs`` placed by ``shardings`` (trees of the same
    shape) on ``device``, their local shards ``torch.empty`` (fake under a
    fake mode); on a mesh of one rank the plain tensors."""
    from torch.distributed.tensor import DTensor

    def leaf(spec, sh):
        local = torch.empty(local_shape(spec, sh), dtype=spec.dtype,
                            device=device)
        if sh.mesh.size() == 1:
            return local
        stride = tuple(math.prod(spec.shape[i + 1:])
                       for i in range(len(spec.shape)))
        return DTensor.from_local(local, sh.mesh, sh.placements,
                                  run_check=False,
                                  shape=torch.Size(spec.shape),
                                  stride=stride)

    return tree_map(leaf, specs, shardings)


def _tensors(tree, local: bool = True) -> list:
    """Every tensor of an argument tree, dataclasses entered (the solver's
    arrays), each DTensor as its local shard (as itself with ``local``
    False)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x.to_local() if local and hasattr(x, "to_local")
                       else x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def argument_bytes(args) -> int:
    """Local bytes of the arguments, each storage once."""
    seen = {}
    for t in _tensors(args):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def trace(case, device) -> dict:
    """Run ``case`` once under the counters; returns the counts
    (``CostCounter.summary``) with ``argument_bytes``, ``output_bytes``
    (new storages still alive with the result) and
    ``comm_debug_counts`` (``CommDebugMode``'s, model steps)."""
    if not case.fake:
        args = case.make_inputs(case.args)
        pm = case.process_mesh
        pm.reset_stats()
        with cost.count(real=True) as c:
            out = case.fn(*args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            rec = c.summary()
        del out
        c.add_process_mesh(pm.stats())
        rec = c.summary() | dict(output_bytes=rec["live_bytes"])
        rec["argument_bytes"] = argument_bytes(args)
        rec["comm_debug_counts"] = {}
        return rec

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    fm = cost.fake_mode()
    with fm:
        args = materialize(case.args, case.in_placements, device)
        if case.make_inputs is not None:
            args = case.make_inputs(args, fm)
        arg_bytes = argument_bytes(args)
        # CommDebugMode sees every op; it has nothing to count where no
        # argument is a DTensor (a mesh of one rank)
        fm.dtensors = any(isinstance(t, DTensor)
                          for t in _tensors(args, local=False))
        cdm = CommDebugMode() if fm.dtensors else None
        with cdm or contextlib.nullcontext(), cost.count(fm) as c:
            out = case.fn(*args)
            rec = c.summary()
        del out
    rec["output_bytes"] = rec["live_bytes"]
    rec["argument_bytes"] = arg_bytes
    rec["comm_debug_counts"] = {} if cdm is None else {
        str(k): v for k, v in cdm.get_comm_counts().items()}
    return rec


def cell_record(case, device, n_chips: int) -> dict:
    """Trace ``case`` (:func:`trace`) and make its record: memory,
    collectives, kernels, one rank's counts and the roofline."""
    t0 = time.perf_counter()
    counts = trace(case, device)
    trace_s = time.perf_counter() - t0
    roof, coll = cost.analyse(counts, n_chips, case.model_flops)
    coll["comm_debug_counts"] = counts["comm_debug_counts"]
    return dict(
        status="ok", comment=case.comment, device=str(device),
        trace_s=round(trace_s, 2), ops=counts["ops"],
        memory=dict(
            argument_bytes=counts["argument_bytes"],
            output_bytes=counts["output_bytes"],
            temp_bytes=counts["peak_bytes"],
            total_per_device=counts["argument_bytes"]
            + counts["peak_bytes"]),
        collectives=coll, kernels=counts["kernels"],
        per_rank=dict(flops=counts["flops"], hbm_bytes=counts["hbm_bytes"],
                      coll_bytes=counts["total_coll_bytes"]),
        roofline=roof.to_dict())


def run_cell(arch_id: str, shape: str, multi_pod: bool, save: bool = True,
             device=None) -> dict:
    device = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device.type)
    name = mesh_name(multi_pod)
    tag = f"{arch_id}__{shape}__{name}".replace("/", "_")
    spec = get_arch(arch_id)

    t0 = time.perf_counter()
    case = spec.make_dryrun_case(shape, mesh)
    head = dict(arch=arch_id, shape=shape, mesh=name)
    if isinstance(case, SkipCell):
        rec = dict(head, status="skip", reason=case.reason)
    else:
        build_s = round(time.perf_counter() - t0, 2)
        rec = dict(head, build_s=build_s,
                   **cell_record(case, device, mesh.size()))
    _emit(tag, rec, save)
    return rec


def _emit(tag, rec, save):
    line = f"[{rec['mesh']}] {rec['arch']}/{rec['shape']}: {rec['status']}"
    if rec["status"] == "ok":
        r, m = rec["roofline"], rec["memory"]
        line += (f" trace={rec['trace_s']}s "
                 f"args={m['argument_bytes'] / 2**30:.2f}GiB "
                 f"temp={m['temp_bytes'] / 2**30:.2f}GiB "
                 f"flops/rank={rec['per_rank']['flops']:.3e} "
                 f"coll/rank={rec['per_rank']['coll_bytes']:.3e}B "
                 f"bottleneck={r['bottleneck']} "
                 f"roofline={r['roofline_fraction']:.3f}")
    else:
        line += f" ({rec['reason'][:90]})"
    print(line, flush=True)
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)


def summary(directory: str = OUT_DIR) -> str:
    """The saved records of ``directory`` as a markdown table, two (arch,
    shape) cells a row, each with its 16×16 and 2×16×16 numbers side by
    side: one rank's GiB (arguments + temporaries), TFLOP and collective
    GB, the bottleneck and the roofline fraction; skipped cells after
    it, by name."""
    recs = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                r = json.load(f)
            recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def pair(cell, fn):
        return " / ".join(fn(cell[m]) if m in cell else "—"
                          for m in ("16x16", "2x16x16"))

    def entry(key, cell):
        return [f"{key[0]}/{key[1]}",
                pair(cell, lambda r:
                     f"{r['memory']['total_per_device'] / 2**30:.2f}"),
                pair(cell, lambda r: f"{r['per_rank']['flops'] / 1e12:.3f}"),
                pair(cell, lambda r:
                     f"{r['per_rank']['coll_bytes'] / 1e9:.3f}"),
                pair(cell, lambda r: f"{r['roofline']['bottleneck']} "
                     f"{r['roofline']['roofline_fraction']:.4f}")]

    ok = [(k, c) for k, c in sorted(recs.items())
          if next(iter(c.values()))["status"] == "ok"]
    skips = [f"{a}/{sh}" for (a, sh), c in sorted(recs.items())
             if next(iter(c.values()))["status"] != "ok"]
    head = ("cell", "GiB", "TFLOP", "coll. GB", "bound, roofline")
    rows = ["| " + " | ".join(head + head) + " |",
            "|" + "---|" * (2 * len(head))]
    half = -(-len(ok) // 2)
    for i in range(half):
        cells = entry(*ok[i])
        cells += entry(*ok[i + half]) if i + half < len(ok) else [""] * 5
        rows.append("| " + " | ".join(cells) + " |")
    if skips:
        rows.append(f"\nSkipped (`SkipCell`): {', '.join(skips)}.")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run 16x16 and 2x16x16")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors and the solver's rank "
                         "program live (default: the CUDA card)")
    ap.add_argument("--summary", action="store_true",
                    help="print the saved records as a markdown table")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary())
        return
    device = resolve_device(args.device)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    meshes = [False, True] if args.both else [args.multi_pod]
    failures = []
    for arch_id in archs:
        spec = get_arch(arch_id)
        shapes = [args.shape] if args.shape else spec.shapes
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch_id, shape, mp, save=not args.no_save,
                             device=device)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((arch_id, shape, mp, repr(e)))
                    print(f"[{mesh_name(mp)}] {arch_id}/{shape}: FAIL {e!r}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
