"""Process meshes on ``torch.distributed``: the port's counterpart of
``jax.make_mesh`` and of the reference's mesh geometry helpers
(``repro.dist.partition.mesh_geometry``, ``check_mesh_matches``).

JAX drives every shard of a mesh from one controller. Here every rank of a
process group runs the same program:

* vectors are replicated on every rank (the paper's vector duplication);
* every rank computes the host partition identically and keeps only its
  own ``(pod, i, j)`` block;
* ``psum`` / ``pmax`` / ``pmin`` over all mesh axes are ONE
  ``all_reduce`` (SUM / MAX / MIN) over the mesh's group: the reference
  reduces over every axis at once too, so no row or column subgroup is
  needed;
* ``axis_index`` is the rank's row-major coordinate.

A rank's coordinates are ``numpy.unravel_index(rank, shape)``, so its
linear shard index is its rank, as the reference's row-major
``_linear_block_index`` is.

Collectives run where the mesh's tensors live. NCCL takes CUDA tensors
(one rank per card: NCCL refuses two ranks on one card, so on one card the
NCCL world is a world of one). Gloo takes CPU tensors; a gloo mesh whose
tensors are on the card copies each reduction through host memory, and
says so: ``stats()["staged"]`` counts those copies. Nothing here switches
device or backend on its own.

:func:`init_world` starts a world of one over a ``FileStore`` in a
temporary directory (no network); :func:`run_world` spawns a world of N
processes on this host, each reporting through a file, joined under a
timeout.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import math
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """A 2D ``(row, col)`` or 3D ``(pod, row, col)`` grid of the ranks of
    ``group``, with the device its tensors live on. Meshes hash and compare
    by identity (they key the setup registry)."""

    shape: tuple
    axis_names: tuple
    group: object
    device: torch.device
    backend: str
    rank: int
    _stats: dict = dataclasses.field(default_factory=lambda: dict(
        calls=0, bytes=0, staged=0), repr=False)

    # -- geometry (the reference's ``mesh_geometry``) ---------------------
    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def pods(self) -> int:
        return self.shape[0] if len(self.shape) == 3 else 1

    @property
    def pr(self) -> int:
        return self.shape[-2]

    @property
    def pc(self) -> int:
        return self.shape[-1]

    @property
    def coords(self) -> tuple:
        """This rank's row-major coordinate along every axis."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    @property
    def block(self) -> tuple:
        """This rank's ``(pod, i, j)`` block of the 2D partition."""
        c = self.coords
        return (c[0] if len(c) == 3 else 0, c[-2], c[-1])

    @property
    def shard_index(self) -> int:
        """This rank's linear shard index, row-major over the axes."""
        return self.rank

    @property
    def staged(self) -> bool:
        """True when the reductions copy through host memory (a gloo group
        whose tensors live on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def axis_sizes(self) -> dict:
        """``{axis name: size}``, the reference's ``dict(mesh.shape)``."""
        return dict(zip(self.axis_names, self.shape))

    # -- collectives -------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        st = self._stats
        st["calls"] += 1
        st["bytes"] += t.numel() * t.element_size()
        if self.staged:
            st["staged"] += 1
            h = t.cpu()
            dist.all_reduce(h, op=op, group=self.group)
            return t.copy_(h)
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over every rank of the mesh. Reduces ``t`` in place (a
        contiguous temporary of the caller) and returns it."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over every rank, in place."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise min over every rank, in place."""
        return self._all_reduce(t, dist.ReduceOp.MIN)

    def stats(self) -> dict:
        """All-reduce calls and bytes since the last reset, and how many
        of them were staged through host memory."""
        return dict(self._stats)

    def reset_stats(self) -> None:
        for k in self._stats:
            self._stats[k] = 0


def make_mesh(shape, axis_names, group=None, device=None) -> ProcessMesh:
    """The mesh of ``shape`` over ``group`` (default: the initialised
    default group), whose product must equal the group's size. ``device``
    is where the mesh's tensors live (default: the CUDA card, see
    ``resolve_device``); an NCCL group needs CUDA tensors."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) not in (2, 3):
        raise ValueError(f"expected a 2D (row, col) or 3D (pod, row, col) "
                         f"mesh, got shape {shape}")
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(axis_names)} axis names for a mesh of "
                         f"shape {shape}")
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call "
                           "init_world() or torch.distributed."
                           "init_process_group() first")
    if group is None:
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    if math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} has {math.prod(shape)} ranks, "
                         f"the group has {size}")
    dev = resolve_device(device)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group needs CUDA tensors, not {dev}")
    return ProcessMesh(shape=shape, axis_names=axis_names, group=group,
                       device=dev, backend=backend,
                       rank=dist.get_rank(group))


def factor_grid(size: int) -> tuple:
    """``(pr, pc)`` with ``pr`` the largest divisor of ``size`` ≤ √size:
    the reference's ``default_mesh`` factoring."""
    pr = max(d for d in range(1, int(size ** 0.5) + 1) if size % d == 0)
    return pr, size // pr


def init_world(device=None) -> ProcessMesh:
    """Initialise a default process group of one rank over a ``FileStore``
    in a new temporary directory (no network): NCCL on a CUDA device, gloo
    on the CPU. Returns its 1×1 ``("data", "model")`` mesh. Raises if a
    default group exists already or the group fails to start."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    path = tempfile.mkdtemp(prefix="repro_torch_world_")
    # at exit, the group goes before its store: an NCCL group left open
    # keeps a monitor thread polling the store, which holds up the exit
    atexit.register(_close_world, path)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    store = dist.FileStore(os.path.join(path, "store"), 1)
    dist.init_process_group(
        backend, store=store, rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return make_mesh((1, 1), ("data", "model"), device=dev)


def _close_world(path: str) -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(path, ignore_errors=True)


# ----------------------------------------------------------------------
# A world of N processes on this host
# ----------------------------------------------------------------------

def _world_child(fn, rank, world_size, tmp, timeout, threads, args):
    out = os.path.join(tmp, f"rank{rank}.pkl")
    if threads:
        torch.set_num_threads(threads)
    status = 0
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = ("ok", fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
    except Exception:                   # reported to the parent, which raises
        result = ("error", traceback.format_exc())
        status = 1
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    sys.exit(status)


def run_world(fn, world_size: int, args: tuple = (), *,
              timeout: float = DEFAULT_TIMEOUT_S,
              threads: int | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes that form one default gloo process group (over a
    ``FileStore`` in a temporary directory: NCCL takes one rank per card,
    so a world of several ranks on one card is gloo; ``fn`` makes its
    mesh on the CPU or, staged, on the card). ``fn`` must be importable by
    its module path and return a picklable result. Each rank writes its
    result (or its traceback) to a file; the parent joins every process
    within ``timeout`` seconds, kills them all and raises ``TimeoutError``
    if one is still running, and raises ``RuntimeError`` with a rank's
    traceback if it failed. Returns the results in rank order.
    ``threads`` sets each child's ``torch.set_num_threads``."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        procs = [ctx.Process(target=_world_child,
                             args=(fn, rank, world_size, tmp, timeout,
                                   threads, tuple(args)))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # poll: a rank that failed leaves the others blocked in a
            # collective, so stop waiting as soon as one exits non-zero
            while any(p.is_alive() for p in procs) \
                    and time.monotonic() < deadline \
                    and not any(p.exitcode for p in procs):
                procs[0].join(0.05)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
            for p in hung:
                p.join(10)
        failed = [r for r, p in enumerate(procs)
                  if os.path.exists(os.path.join(tmp, f"rank{r}.pkl"))
                  and p.exitcode]
        if hung and not failed:
            raise TimeoutError(f"{len(hung)} of {world_size} ranks still "
                               f"ran after {timeout} s; killed")
        if failed:
            # earliest first: the ranks a failure leaves in a collective
            # fail after it, with errors of their own
            failed.sort(key=lambda r: os.stat(
                os.path.join(tmp, f"rank{r}.pkl")).st_mtime_ns)
            reports = []
            for rank in failed:
                with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                    reports.append(f"rank {rank} failed:\n{pickle.load(f)[1]}")
            raise RuntimeError("\n".join(reports))
        results = []
        for rank in range(world_size):
            path = os.path.join(tmp, f"rank{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {rank} exited with code "
                                   f"{procs[rank].exitcode} and wrote no "
                                   f"result")
            with open(path, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
