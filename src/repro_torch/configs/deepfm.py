"""deepfm [recsys]: n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm
[arXiv:1703.04247]; torch port of ``repro.configs.deepfm``.

Shapes: train_batch (B=65536, train step), serve_p99 (B=512, online
inference), serve_bulk (B=262144, offline scoring), retrieval_cand (B=1
against 10⁶ candidates, FM-decomposed). The port trains
(:func:`make_train_step`: the loss, the gradient of every parameter, then
AdamW, as the reference's train step) and serves the other three.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import (ArchSpec, DryrunCase, TensorSpec,
                                          register)
from repro_torch.device import resolve_device
from repro_torch.models.recsys.deepfm import (DeepFMConfig, deepfm_forward,
                                              deepfm_loss, default_vocabs,
                                              fm_retrieval_scores,
                                              init_deepfm)
from repro_torch.models.sharding import NamedSharding, P, _dp_axes
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_map, value_and_grad

FULL = DeepFMConfig(n_fields=39, embed_dim=10, mlp_sizes=(400, 400, 400),
                    vocab_per_field=default_vocabs(39), multi_hot=2)
SMOKE = DeepFMConfig(n_fields=6, embed_dim=4, mlp_sizes=(16, 16),
                     vocab_per_field=(50, 20, 20, 10, 10, 8), multi_hot=2)

SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
SHAPE_DIMS = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve"),
    serve_bulk=dict(batch=262144, kind="serve"),
    retrieval_cand=dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
)


def _train_flops(cfg: DeepFMConfig, B) -> float:
    """Model FLOPs of one training step of batch ``B`` (forward + backward,
    3× the forward)."""
    d, F = cfg.embed_dim, cfg.n_fields
    mlp = 0
    sizes = [F * d, *cfg.mlp_sizes, 1]
    for a, b in zip(sizes[:-1], sizes[1:]):
        mlp += 2 * a * b
    fm = 4 * F * d
    gather = 2 * F * cfg.multi_hot * d
    return 3.0 * B * (mlp + fm + gather)


def serve_flops(cfg: DeepFMConfig, B) -> float:
    """Model FLOPs of one forward of batch ``B``: a third of a train step."""
    return _train_flops(cfg, B) / 3.0


def loss_and_grads(cfg: DeepFMConfig, params: dict, indices: torch.Tensor,
                   labels: torch.Tensor):
    """``deepfm_loss`` and its gradient in every parameter (a tree shaped
    like ``params``): the reference's ``jax.value_and_grad``. ``params``
    is left as it is."""
    return value_and_grad(lambda p: deepfm_loss(cfg, p, indices, labels),
                          params)


def make_train_step(cfg: DeepFMConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    donate: bool = False):
    """The reference's train step (``repro.configs.deepfm``, the
    ``train_batch`` case): ``step(params, opt_state, indices, labels) ->
    (params, opt_state, {"loss", "grad_norm", "lr"})``, loss and gradients
    then ``adamw_update``; functional (with ``donate``, AdamW writes into
    the given trees), every tensor on the parameters' device."""
    def step(params, opt_state, indices, labels):
        loss, grads = loss_and_grads(cfg, params, indices, labels)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state, donate=donate)
        return params, opt_state, dict(loss=loss, **metrics)

    return step


def param_shapes(cfg: DeepFMConfig) -> dict:
    """``init_deepfm``'s tree as :class:`TensorSpec` leaves, traced on fake
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_deepfm(cfg, torch.Generator(), "cpu")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), params)


def _replicating(fn):
    """``fn`` with the tensors it makes itself (field offsets, masks)
    taken as replicated on the mesh of its DTensor arguments."""
    def run(*args):
        from torch.distributed.tensor.experimental import (
            implicit_replication)

        with implicit_replication():
            return fn(*args)
    return run


def make_dryrun_case(shape_name, mesh, cfg: DeepFMConfig = FULL):
    """The reference's DeepFM dry-run case on ``mesh``: the fused table and
    first-order weights row-split over ``"model"``, the MLP replicated,
    the batch over the DP axes; the train step donates its state."""
    dims = SHAPE_DIMS[shape_name]
    pshapes = param_shapes(cfg)
    rep = NamedSharding(mesh, P())
    table_sh = NamedSharding(mesh, P("model", None))   # row-sharded tables
    params_sh = dict(table=table_sh, first_order=table_sh,
                     mlp=tree_map(lambda _: rep, pshapes["mlp"]), bias=rep)
    dp = _dp_axes(mesh)
    B = dims["batch"]
    F, H = cfg.n_fields, cfg.multi_hot
    name = f"deepfm/{shape_name}"

    if dims["kind"] == "train":
        batch = (TensorSpec((B, F, H), torch.int32),
                 TensorSpec((B,), torch.float32))
        batch_sh = (NamedSharding(mesh, P(dp, None, None)),
                    NamedSharding(mesh, P(dp)))
        opt = dict(mu=pshapes, nu=pshapes,
                   step=TensorSpec((), torch.int32))
        return DryrunCase(
            name=name,
            fn=_replicating(make_train_step(cfg, AdamWConfig(),
                                            donate=True)),
            build_args=lambda: (pshapes, opt) + batch,
            in_placements=(params_sh, dict(mu=params_sh, nu=params_sh,
                                           step=rep)) + batch_sh,
            out_placements=(params_sh, dict(mu=params_sh, nu=params_sh,
                                            step=rep),
                            dict(loss=rep, grad_norm=rep, lr=rep)),
            model_flops=_train_flops(cfg, B),
            comment="train_step: embedding-bag + FM + deep MLP + AdamW")

    if dims["kind"] == "serve":
        def serve(params, idx):
            with torch.no_grad():
                return deepfm_forward(cfg, params, idx)

        return DryrunCase(
            name=name, fn=_replicating(serve),
            build_args=lambda: (pshapes, TensorSpec((B, F, H), torch.int32)),
            in_placements=(params_sh, NamedSharding(mesh, P(dp, None, None))),
            out_placements=NamedSharding(mesh, P(dp)),
            model_flops=_train_flops(cfg, B) / 3.0,
            comment="serve_step: forward scoring")

    # 10⁶ candidates shard over 'model' (16 | 10⁶); the full axis product
    # (512) does not divide it
    n_cand = dims["n_candidates"]

    def retrieve(params, u, cand):
        with torch.no_grad():
            return fm_retrieval_scores(cfg, params, u, cand)

    return DryrunCase(
        name=name, fn=_replicating(retrieve),
        build_args=lambda: (pshapes, TensorSpec((1, F, H), torch.int32),
                            TensorSpec((n_cand,), torch.int32)),
        in_placements=(params_sh, rep, NamedSharding(mesh, P("model"))),
        out_placements=NamedSharding(mesh, P("model")),
        model_flops=2.0 * n_cand * cfg.embed_dim,
        comment="retrieval: FM-decomposed candidate scoring (1M batched dot)")


def make_smoke_case(device=None):
    """The reference's smoke case on ``SMOKE`` (B = 8, its numpy draws;
    the weights from a seeded ``torch.Generator``): the loss, the
    gradients and 100 retrieval scores, on ``device`` (default: the CUDA
    card)."""
    def run():
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        cfg = SMOKE
        params = init_deepfm(cfg, torch.Generator().manual_seed(0), dev)
        B = 8
        sizes = np.asarray(cfg.vocab_per_field)
        idx = (rng.integers(0, 1 << 30, (B, cfg.n_fields, cfg.multi_hot))
               % sizes[None, :, None]).astype(np.int32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        idx_t = torch.from_numpy(idx).to(dev)
        loss, grads = loss_and_grads(cfg, params, idx_t,
                                     torch.from_numpy(labels).to(dev))
        cand = torch.as_tensor(rng.integers(0, sizes[0], 100),
                               dtype=torch.int32, device=dev)
        with torch.no_grad():
            scores = fm_retrieval_scores(cfg, params, idx_t[:1], cand)
        return dict(loss=loss, scores=scores, grads=grads)
    return run


register(ArchSpec(
    arch_id="deepfm", family="recsys", shapes=SHAPES,
    make_dryrun_case=make_dryrun_case,
    make_smoke_case=make_smoke_case, describe=__doc__))
