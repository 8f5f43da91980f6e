"""DeepFM (Guo et al., arXiv:1703.04247): torch port of
``repro.models.recsys.deepfm``.

One fused ``[Σ vocab, d]`` table with per-field offsets; the FM second
order term uses the ½[(Σv)² − Σv²] identity; retrieval scores one user
against many candidates of one field with the FM decomposition (one
``[n_cand, d] @ [d]`` product). Both multi-hot bag sums of a forward (the
field embeddings and the first-order weights) run through the
embedding-bag kernel on the card, and where the parameters require grad
their gradients through its backward kernel (``kernels.embedding_bag.
BagSum``), over one sort of the batch's ids that both share
(``bag_grad_plan``). The training step (loss, gradients, AdamW) is
``repro_torch.configs.deepfm.make_train_step``. The products run in full
float32: callers on the card keep TF32 off, as the reference's are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import bag_grad_plan
from repro_torch.models.gnn.common import init_mlp, mlp_apply
from repro_torch.models.recsys.embedding import embedding_bag
from repro_torch.sparse.segment import take_fill


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_fields: int = 39
    embed_dim: int = 10
    mlp_sizes: tuple = (400, 400, 400)
    vocab_per_field: tuple = ()          # len == n_fields
    multi_hot: int = 1                   # H per field (1 = one-hot)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_per_field))

    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_per_field)[:-1]]
                              ).astype(np.int32)


def default_vocabs(n_fields: int = 39, scale: float = 1.0) -> tuple:
    """Criteo-like skew: a few huge id spaces, many small ones."""
    sizes = []
    for i in range(n_fields):
        if i % 13 == 0:
            sizes.append(int(1_000_000 * scale))
        elif i % 5 == 0:
            sizes.append(int(100_000 * scale))
        else:
            sizes.append(max(int(1_000 * scale), 4))
    return tuple(max(s, 4) for s in sizes)


def padded_rows(cfg: DeepFMConfig) -> int:
    """Table rows: ``total_vocab`` rounded up to a multiple of 512, as the
    reference pads them for row sharding (the padding rows are never
    indexed)."""
    return -(-cfg.total_vocab // 512) * 512


def init_deepfm(cfg: DeepFMConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters: ``table`` [V, d] and ``first_order`` [V, 1] at
    N(0, 0.01²), the MLP ``[F·d, *mlp_sizes, 1]``, ``bias`` 0. Drawn from
    ``generator`` on its own device, then moved to ``device`` (default: the
    CUDA card)."""
    device = resolve_device(device)
    d, F = cfg.embed_dim, cfg.n_fields
    V = padded_rows(cfg)

    def normal(shape):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * 0.01).to(device)

    return dict(table=normal((V, d)), first_order=normal((V, 1)),
                mlp=init_mlp([F * d, *cfg.mlp_sizes, 1], generator, device),
                bias=torch.zeros((), device=device))


def _flat_ids(cfg: DeepFMConfig, indices: torch.Tensor) -> torch.Tensor:
    """Field-local ids [B, F, H] -> fused-table ids; negative ids stay -1."""
    offsets = torch.as_tensor(cfg.field_offsets(),
                              device=indices.device)[None, :, None]
    return torch.where(indices >= 0, indices + offsets, -1)


def _field_embeddings(cfg: DeepFMConfig, params: dict,
                      indices: torch.Tensor) -> torch.Tensor:
    """indices [B, F, H] (field-local ids) -> [B, F, d] bag-summed."""
    return embedding_bag(params["table"], _flat_ids(cfg, indices))


def deepfm_forward(cfg: DeepFMConfig, params: dict,
                   indices: torch.Tensor) -> torch.Tensor:
    """indices [B, F, H] int32 -> logits [B]. Where a table requires grad
    (and grad is enabled), the batch's ids are sorted once
    (``bag_grad_plan``) for both tables' backward."""
    flat_ids = _flat_ids(cfg, indices)
    table, first_order = params["table"], params["first_order"]
    plan = None
    # (a DTensor table on a mesh sums its own rows: each bag sum builds
    # the plan of its rank's ids)
    if torch.is_grad_enabled() and not hasattr(table, "device_mesh") and (
            table.requires_grad or first_order.requires_grad):
        plan = bag_grad_plan(flat_ids.reshape(-1, flat_ids.shape[-1]),
                             table.shape[0])
    v = embedding_bag(table, flat_ids, plan=plan)            # [B, F, d]
    first = embedding_bag(first_order, flat_ids, plan=plan).sum(dim=(1, 2))

    # FM second order: ½ Σ_d [(Σ_f v)² − Σ_f v²]
    sum_v = v.sum(dim=1)
    fm = 0.5 * (sum_v.square() - v.square().sum(dim=1)).sum(dim=-1)

    deep = mlp_apply(params["mlp"], v.reshape(v.shape[0], -1))[:, 0]
    return params["bias"] + first + fm + deep


def deepfm_loss(cfg: DeepFMConfig, params: dict, indices: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of the logits; differentiable in every
    parameter that requires grad."""
    logits = deepfm_forward(cfg, params, indices)
    return torch.mean(logits.clamp(min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def fm_retrieval_scores(cfg: DeepFMConfig, params: dict,
                        user_indices: torch.Tensor,
                        candidate_ids: torch.Tensor,
                        item_field: int = 0) -> torch.Tensor:
    """Score 1 user against ``n_cand`` field-local ids of one item field.

    user_indices [1, F, H] (the item field's slots are ignored);
    candidate_ids [n_cand]. score(c) = w1[c] + ⟨Σ v_user, v_c⟩: one
    ``[n_cand, d] @ [d]`` product. The candidate rows are gathered as the
    reference's ``jnp.take(mode="fill")`` does: a fused id in ``[-V, 0)``
    wraps to ``id + V`` (V table rows), ids below ``-V`` or from ``V`` on
    give 0.
    """
    v = _field_embeddings(cfg, params, user_indices)         # [1, F, d]
    mask = (torch.arange(cfg.n_fields, device=v.device)
            != item_field)[None, :, None]
    v_user = torch.where(mask, v, 0).sum(dim=1)[0]           # [d]
    ids = candidate_ids + int(cfg.field_offsets()[item_field])
    ids = torch.where(ids < 0, ids + params["table"].shape[0], ids)
    cand_vec = take_fill(params["table"], ids, 0)            # [n_cand, d]
    cand_w1 = take_fill(params["first_order"], ids, 0)[:, 0]
    return cand_w1 + cand_vec @ v_user


class DeepFM(nn.Module):
    """DeepFM: ``forward(indices)`` is :func:`deepfm_forward`.

    Built from ``params`` (a dict as :func:`init_deepfm` returns) or drawn
    from ``generator``; on ``device`` (default: the CUDA card). The weights
    are parameters that require grad, so ``deepfm_loss(cfg, model.params(),
    ...)`` trains them; serve under ``torch.no_grad()``, which builds no
    graph.
    """

    def __init__(self, cfg: DeepFMConfig, generator: torch.Generator | None
                 = None, device=None, params: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        if params is None:
            if generator is None:
                raise ValueError("DeepFM: pass a generator or params")
            params = init_deepfm(cfg, generator, device)
        self.cfg = cfg

        def param(t):
            return nn.Parameter(t.detach().to(device))

        self.table = param(params["table"])
        self.first_order = param(params["first_order"])
        self.bias = param(params["bias"])
        self.mlp_w = nn.ParameterList(param(w) for w in params["mlp"]["w"])
        self.mlp_b = nn.ParameterList(param(b) for b in params["mlp"]["b"])

    def params(self) -> dict:
        """The parameters in :func:`init_deepfm`'s layout."""
        return dict(table=self.table, first_order=self.first_order,
                    mlp={"w": list(self.mlp_w), "b": list(self.mlp_b)},
                    bias=self.bias)

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return deepfm_forward(self.cfg, self.params(), indices)

    def retrieval_scores(self, user_indices: torch.Tensor,
                         candidate_ids: torch.Tensor,
                         item_field: int = 0) -> torch.Tensor:
        return fm_retrieval_scores(self.cfg, self.params(), user_indices,
                                   candidate_ids, item_field)
