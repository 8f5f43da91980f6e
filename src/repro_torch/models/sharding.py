"""Sharding plans: where the DP / TP / EP / SP axes land for each model
family (torch port of ``repro.models.sharding``).

A plan is a mesh (a ``torch.distributed`` ``DeviceMesh``) and a table of
named specs. A spec is the reference's ``PartitionSpec`` as a tuple,
:class:`P`: one entry a tensor dim, each ``None`` (not sharded), a mesh
axis name, or a tuple of axis names (sharded over their product, major
first). :func:`placements` turns a spec into DTensor placements on the
mesh: ``Shard(d)`` on every mesh dim that tensor dim ``d`` names,
``Replicate()`` on the others. The tables hold the reference's entries
name for name.

Models call ``plan.shard(x, "activation_name")`` at the points where the
reference hints XLA's partitioner (post-embedding activations, attention
outputs, logits). With a mesh that is a redistribution of the DTensor
``x`` to the named placements; with no mesh (``null_plan()``, every
single-card path) it is the identity, and no model code touches DTensor.
``moe_token_shards`` is the reference's MoE dispatch partition count (its
DP-axis size): ``models.transformer.moe_ffn`` ranks and fills the expert
queues per token shard.

Axis conventions:
  batch  -> ("pod", "data")   data parallelism (pod axis folds into DP)
  heads / d_ff / vocab / experts -> "model"   tensor / expert parallelism
  sequence -> optional DP sharding for long context (SP)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class P:
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"),
    None)``; trailing dims it does not name are not sharded. A leaf of the
    port's trees (not a tuple, which a tree walk would enter); it compares
    equal to the tuple of its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        other = other.entries if isinstance(other, P) else other
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (one a mesh dim).
    Raises if the spec names an axis the mesh lacks, names one twice, or
    lists a dim's axes out of the mesh's order (DTensor shards a tensor
    dim over its mesh dims major first, in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx or seen & set(axes) or idx != sorted(idx):
            raise ValueError(f"spec {spec!r} does not fit mesh axes {names}")
        seen |= set(axes)
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape_offset(shape, mesh, placements) -> tuple:
    """``(local shape, global offset)`` of this rank's shard of a tensor
    of ``shape`` placed by ``placements`` on ``mesh`` (DTensor's split:
    the first ranks take the larger chunks). Computed on real tensors
    even under a fake mode (the mesh's coordinates are real)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    with unset_fake_temporarily():
        shape, offset = compute_local_shape_and_global_offset(
            tuple(shape), mesh, placements)
    return tuple(shape), tuple(offset)


def distribute(t, sharding):
    """This rank's shard of the full tensor ``t`` as a DTensor placed by
    ``sharding`` (a :class:`NamedSharding`), cut locally: no collective.
    On the mesh's device type (the current CUDA device for ``cuda``)."""
    import torch
    from torch.distributed.tensor import DTensor

    mesh, pl = sharding.mesh, sharding.placements
    shape, offset = local_shape_offset(t.shape, mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return DTensor.from_local(local.contiguous().to(dev), mesh, pl,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Optional[object]
    specs: dict
    moe_token_shards: int = 1   # DP-axis size: MoE dispatch partitions per shard

    def spec(self, name: str) -> P:
        return self.specs.get(name, P())

    def named(self, name: str) -> NamedSharding:
        assert self.mesh is not None
        return NamedSharding(self.mesh, self.spec(name))

    def placements(self, name: str) -> tuple:
        return placements(self.spec(name), self.mesh)

    def shard(self, x, name: str):
        if self.mesh is None or name not in self.specs:
            return x
        return x.redistribute(self.mesh, self.placements(name))

    def dp_size(self) -> int:
        return _mesh_size(self.mesh, _dp_axes(self.mesh))

    def axis_size(self, axis: str) -> int:
        return _mesh_size(self.mesh, (axis,))


def _mesh_size(mesh, axes) -> int:
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        if a in names:
            n *= mesh.size(names.index(a))
    return n


def _dp_axes(mesh) -> tuple:
    return ("pod", "data") if (mesh is not None
                               and "pod" in mesh.mesh_dim_names) \
        else ("data",)


def null_plan() -> ShardingPlan:
    return ShardingPlan(mesh=None, specs={})


def make_lm_plan(mesh, seq_sharded: bool = False) -> ShardingPlan:
    """Megatron-style DP×TP (+EP over 'model'); optional sequence sharding."""
    dp = _dp_axes(mesh)
    specs = {
        # --- params -----------------------------------------------------
        "embed": P(None, "model"),          # [V, d]
        "wq": P(None, None, "model"),       # [L, d, H*dh] heads sharded
        "wkv": P(None, None, "model"),
        "wo": P(None, "model", None),
        "w_in": P(None, None, "model"),     # [L, d, ff]
        "w_out": P(None, "model", None),    # [L, ff, d]
        "moe_w_in": P(None, "model", None, None),    # [L, E, d, ff_e]
        "moe_w_out": P(None, "model", None, None),   # [L, E, ff_e, d]
        "router": P(),                       # [L, d, E] tiny, replicated
        "norm": P(),
        "lm_head": P(None, "model"),         # [d, V]
        "bias_model": P(None, "model"),      # biases of model-sharded matmuls
        # --- activations --------------------------------------------------
        "tokens": P(dp, None),               # [B, S]
        "act": P(dp, "model", None) if seq_sharded
               else P(dp, None, None),       # [B, S, d]
        "act_heads": P(dp, None, "model", None),   # [B, S, H, dh]
        "logits": P(dp, None, "model"),      # [B, S, V]
        "kv_cache": P(dp, None, "model", None),    # [B, S, n_kv, dh]
        "moe_buf": P(dp, "model", None, None),     # [shards, E, cap, d]
        "loss": P(),
    }
    return ShardingPlan(mesh=mesh, specs=specs,
                        moe_token_shards=_mesh_size(mesh, dp))


def make_gnn_plan(mesh) -> ShardingPlan:
    """Edge-parallel message passing: the paper's 1D fallback for O(n)-work
    objects — edges sharded over all devices, node states replicated over
    'model' (full 2D partitioning is exercised by the solver itself)."""
    dp = _dp_axes(mesh)
    specs = {
        "edge_index": P(None, (dp + ("model",))),   # [2, E] edges sharded
        "edge_feat": P((dp + ("model",)), None),
        "node_feat": P(),                             # replicated [N, d]
        "pos": P(),
        "batch_nodes": P(dp, None),                   # batched small graphs
        "params": P(),
    }
    return ShardingPlan(mesh=mesh, specs=specs)


def make_recsys_plan(mesh) -> ShardingPlan:
    dp = _dp_axes(mesh)
    specs = {
        "table": P("model", None),       # [rows, dim] row-sharded tables
        "dense_w": P(),
        "batch": P(dp),                  # [B, ...] inputs
        "batch2": P(dp, None),
        "batch3": P(dp, None, None),
        "act": P(dp, None),
        "candidates": P(("model",), None),   # [n_cand, d] sharded scoring
        "loss": P(),
    }
    return ShardingPlan(mesh=mesh, specs=specs)
