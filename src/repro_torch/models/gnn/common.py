"""Of ``repro.models.gnn.common``: the ``GraphBatch`` container and the
tiny MLP substrate (``init_mlp``, ``mlp_apply``), as plain functions over a
``{"w": [...], "b": [...]}`` dict. Weights keep the reference's
``[in, out]`` layout, so ``x @ w + b``. The products go to
``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Padded graph (or batch of graphs flattened into one), as tensors on
    one device.

    ``senders``/``receivers``: [E] int32, sentinel = n_nodes for padding.
    ``node_feat``: [N, d]; optional positions [N, 3] and edge feats [E, de].
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    node_feat: torch.Tensor
    edge_feat: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    graph_id: Optional[torch.Tensor] = None   # [N] for batched small graphs

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def edge_valid(self) -> torch.Tensor:
        return self.senders < self.n_nodes


def init_mlp(sizes, generator: torch.Generator, device=None) -> dict:
    """float32 weights ``N(0, 1/fan_in)`` of shape ``[sizes[i],
    sizes[i+1]]`` and zero biases. The draws come from ``generator`` on its
    own device and are then moved to ``device`` (default: the CUDA card),
    so the weights do not depend on where they are used."""
    device = resolve_device(device)
    params = {"w": [], "b": []}
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        params["w"].append(w.to(device))
        params["b"].append(torch.zeros(fan_out, device=device))
    return params


def mlp_apply(params: dict, x: torch.Tensor, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x
