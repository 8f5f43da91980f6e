"""Fault-tolerant checkpointing (torch port of ``repro.checkpoint.ckpt``).

Layout, byte for byte the reference's: ``<dir>/step_<n:08d>/`` holding one
``.npy`` per leaf (named by its flattened key path, ``/`` written as
``__``) plus ``manifest.json`` (step, wall time, ``extra``, and per leaf
its file, shape and dtype string). Writes go to ``step_<n>.tmp`` and are
published with an atomic ``os.replace``, so a job killed mid-save never
leaves a half-readable step: ``latest_step`` only sees completed renames.
A step written by either package loads in the other.

Trees are nested dicts, lists and tuples; ``None`` holds no leaf and
anything else is a leaf (a tensor, a numpy array or a scalar). Key paths
follow ``jax.tree_util.tree_flatten_with_path``: dict keys in sorted
order, list and tuple entries by index. Leaves are saved as host arrays
and restored onto one torch device (the reference's sharded restore,
``shardings=``, waits for its consumer, ``runtime/loop.py``: ROADMAP A12).
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np


def _flatten_with_paths(tree, path=()):
    """``[(key path tuple, leaf)]`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], path + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _flatten_with_paths(sub, path + (str(i),))
        return out
    return [(path, tree)]


def _flatten(tree) -> dict:
    return {"/".join(path): leaf for path, leaf in _flatten_with_paths(tree)}


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(sub, leaves) for sub in tree_like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
    for key, leaf in _flatten(tree).items():
        arr = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = dict(file=fname, shape=list(arr.shape),
                                       dtype=str(arr.dtype))
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


def restore_checkpoint(directory: str, step: int, tree_like, device=None):
    """Restore into the structure of ``tree_like``, as tensors on
    ``device`` (default: the CUDA card; ``device="cpu"`` for the host).
    Returns ``(tree, manifest)``."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for key in _flatten(tree_like):
        info = manifest["leaves"][key]
        arr = np.load(os.path.join(path, info["file"]))
        leaves.append(torch.as_tensor(arr, device=dev))
    return _unflatten(tree_like, iter(leaves)), manifest
