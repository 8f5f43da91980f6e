"""Fault-tolerant checkpointing (torch port of ``repro.checkpoint.ckpt``).

Layout, byte for byte the reference's: ``<dir>/step_<n:08d>/`` holding one
``.npy`` per leaf (named by its flattened key path, ``/`` written as
``__``) plus ``manifest.json`` (step, wall time, ``extra``, and per leaf
its file, shape and dtype string). Writes go to ``step_<n>.tmp`` and are
published with an atomic ``os.replace``, so a job killed mid-save never
leaves a half-readable step: ``latest_step`` only sees completed renames.
A step written by either package loads in the other.

Trees are nested dicts, lists and tuples (``repro_torch.tree``); ``None``
holds no leaf and anything else is a leaf (a tensor, a numpy array or a
scalar). Key paths follow ``jax.tree_util.tree_flatten_with_path``: dict
keys in sorted order, list and tuple entries by index. Leaves are saved as
host arrays. ``restore_checkpoint`` places each leaf as its
``shardings`` tree says (the reference's ``shardings=``, which places each
leaf with ``jax.device_put``): on a torch device, or by a
``models.sharding.NamedSharding`` onto a ``DeviceMesh`` as a DTensor whose
local shard this rank cuts from the file (no collective); every other
leaf goes to ``device``.

bfloat16 leaves are written as the reference writes them (through
``ml_dtypes``, which the port does not need): the raw 2-byte values under
an ``.npy`` header of type ``<V2``, with ``"bfloat16"`` in the manifest,
and restored by the manifest's dtype string. (The reference itself cannot
restore such a leaf: ROADMAP C7.)
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import flatten_with_paths, unflatten


def _flatten(tree) -> dict:
    return {"/".join(path): leaf for path, leaf in flatten_with_paths(tree)}


_BF16 = "bfloat16"
# threads for the leaves' device copies and file writes or reads, which
# release the GIL, so one leaf's copy overlaps another's file I/O (a
# 6.3-GB LM state saves and restores in the LM training loop)
_WORKERS = 8


def _host(leaf) -> np.ndarray:
    """A leaf as a host array; bfloat16 as its raw 2-byte values (``V2``)."""
    if hasattr(leaf, "detach"):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.view("V2") if arr.dtype.name == _BF16 else arr


def _save_npy(path: str, arr: np.ndarray, dtype_name: str) -> None:
    """``np.save``'s bytes; a bfloat16 leaf under the ``<V2`` header that
    ``np.save`` writes for an ``ml_dtypes`` array."""
    if dtype_name != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, dict(descr="<V2", fortran_order=False, shape=arr.shape))
        np.ascontiguousarray(arr).tofile(f)


def save_checkpoint(directory: str, step: int, tree,
                    extra: dict | None = None):
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = dict(step=step, time=time.time(), extra=extra or {},
                    leaves={})

    def write(item):
        key, leaf = item
        arr = _host(leaf)
        dtype = _BF16 if arr.dtype == np.dtype("V2") else str(arr.dtype)
        fname = key.replace("/", "__") + ".npy"
        _save_npy(os.path.join(tmp, fname), arr, dtype)
        return key, dict(file=fname, shape=list(arr.shape), dtype=dtype)

    with ThreadPoolExecutor(_WORKERS) as pool:   # leaves in tree order
        manifest["leaves"].update(pool.map(write, _flatten(tree).items()))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)   # atomic publish
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint_flat(directory: str, step: int):
    """Load a saved step as a flat ``{key: np.ndarray}`` dict + manifest.

    No ``tree_like`` needed: consumers that key their leaves themselves
    (the service's flush checkpoints) restore by flattened key path.
    """
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {key: np.load(os.path.join(path, info["file"]))
            for key, info in manifest["leaves"].items()}
    return flat, manifest


def _place(t: torch.Tensor, sharding, default):
    """``t`` (a host tensor) where ``sharding`` puts it: a torch device,
    or a ``NamedSharding`` (this rank's shard of ``t`` as a DTensor on the
    mesh, ``models.sharding.distribute``)."""
    if sharding is None:
        return t.to(default)
    if not hasattr(sharding, "placements"):
        return t.to(torch.device(sharding))
    from repro_torch.models.sharding import distribute

    return distribute(t, sharding)


def restore_checkpoint(directory: str, step: int, tree_like, device=None,
                       shardings=None):
    """Restore into the structure of ``tree_like``. ``shardings``, a tree
    shaped like ``tree_like`` (or a part of it) whose leaves are torch
    devices or ``models.sharding.NamedSharding``s, places each of its
    leaves there (a sharding as a DTensor of this rank's shard); every
    other leaf goes to ``device`` (default: the CUDA card; ``device="cpu"``
    for the host). Returns ``(tree, manifest)``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_sh = _flatten(shardings) if shardings is not None else {}
    keys = list(_flatten(tree_like))
    default = (None if all(k in flat_sh for k in keys)
               else resolve_device(device))

    def load(key):
        info = manifest["leaves"][key]
        arr = np.load(os.path.join(path, info["file"]))
        if info["dtype"] == _BF16:
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.as_tensor(arr)
        return _place(t, flat_sh.get(key), default)

    with ThreadPoolExecutor(_WORKERS) as pool:
        leaves = list(pool.map(load, keys))
    return unflatten(tree_like, iter(leaves)), manifest
