"""Sharding plans: torch port of ``repro.models.sharding``'s
``ShardingPlan`` and ``null_plan``.

A plan is a mesh and a table of named placements; the models call
``plan.shard(x, "activation_name")`` at the few points where the
reference hints XLA's partitioner (post-embedding activations, attention
outputs, logits). With no mesh every call is the identity, which is the
only plan the port runs so far: one card holds the whole model.
``moe_token_shards`` is the reference's MoE dispatch partition count (its
DP-axis size): ``models.transformer.moe_ffn`` ranks and fills the expert
queues per token shard, also without a mesh. The reference's spec tables (``make_lm_plan``, ``make_gnn_plan``,
``make_recsys_plan``) and the models' ``param_specs`` feed XLA's SPMD
partitioner; their port waits for the dry-run (ROADMAP A16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Optional[object]
    specs: dict
    moe_token_shards: int = 1   # DP-axis size: MoE dispatch partitions per shard

    def shard(self, x, name: str):
        if self.mesh is None or name not in self.specs:
            return x
        raise NotImplementedError(
            "placing a tensor on a mesh by a sharding plan is not ported "
            "yet (ROADMAP A16)")


def null_plan() -> ShardingPlan:
    return ShardingPlan(mesh=None, specs={})
