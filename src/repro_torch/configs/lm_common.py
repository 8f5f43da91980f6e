"""Shared LM-family machinery: torch port of ``repro.configs.lm_common``
(the four assigned shapes, the train step with microbatches, the
microbatch rule, the dry-run cases with the ZeRO rule, the smoke case and
the registration).

LM shapes (assigned): train_4k, prefill_32k, decode_32k, long_500k. All
the assigned LM archs use full (quadratic) GQA attention, so
``long_500k`` (a 524,288-token decode) is a noted skip of the dry-run.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import (ArchSpec, DryrunCase, SkipCell,
                                          TensorSpec, register)
from repro_torch.device import resolve_device
from repro_torch.models.sharding import (NamedSharding, P, _dp_axes,
                                         make_lm_plan, null_plan)
from repro_torch.models.transformer import (TransformerConfig, decode_step,
                                            forward, init_kv_cache,
                                            init_params, lm_loss,
                                            param_specs)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_map, value_and_grad

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SHAPE_DIMS = dict(
    train_4k=dict(seq_len=4096, global_batch=256, kind="train"),
    prefill_32k=dict(seq_len=32768, global_batch=32, kind="prefill"),
    decode_32k=dict(seq_len=32768, global_batch=128, kind="decode"),
    long_500k=dict(seq_len=524288, global_batch=1, kind="decode"),
)
# train_4k on one 80-GB H100 (chip_smoke.py's lm phase, trace_lm.py): its
# global batch of 256 cut to 16 (a 256-sequence step is 16 times the
# work), in 4 microbatches of 4 (the float32 logits chain of one
# microbatch of 16 × 4,096 would need ≈ 120 GB)
CARD_BATCH, CARD_MICROBATCHES = 16, 4
# the MoE configs on one card (chip_smoke.py's moe phase, trace_lm.py).
# moonshot-v1-16b-a3b: 4 of its 48 layers, 3.02 G parameters (1.016 G
# active); training with microbatches and the step's state donated costs
# ≈ 16 B a parameter (bf16 weights 2, a microbatch's gradient 2, the
# float32 accumulator 4, float32 moments 8: ≈ 48 GB), plus a microbatch's
# logits chain (1 × 4,096 × 163,840 × 12 B ≈ 8 GB) and AdamW's float32
# temporaries (≈ 3 GB each for moe_gate/moe_up/moe_down); 6 layers would
# need ≈ 84 GB. train_4k's batch 256 cut to 8 in 8 microbatches of 1 (one
# of 2 × 4,096 would push the peak past ≈ 75 GB); decode_32k's batch 128
# cut to 32 (its MHA cache is 268 MB a sequence a layer: 137 GB at 128).
# arctic-480b: 1 of its 35 layers (14.07 G parameters, 28.1 GB in bf16),
# forward and decode only (its training state is ≈ 84 GB a layer)
MOE_CARD_LAYERS = 4
MOE_CARD_BATCH, MOE_CARD_MICROBATCHES = 8, 8
MOE_CARD_DECODE_BATCH = 32
ARCTIC_CARD_LAYERS = 1


def lm_train_step(cfg: TransformerConfig, plan, opt_cfg: AdamWConfig,
                  n_microbatches: int = 1, accum_dtype=torch.float32,
                  donate: bool = False):
    """``step(params, opt_state, tokens [B, S+1]) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``: the loss and its gradients by
    autograd, then ``adamw_update``; functional, as the reference's. With
    ``n_microbatches`` > 1 the batch splits into that many equal parts,
    one after another (the activations scale with the part); their
    gradients are summed in ``accum_dtype`` and divided by their count,
    and so is the loss (float32), in the reference's order. ``donate``
    (the reference trainer's ``donate_argnums=(0, 1)``): the update is
    written into ``params`` and ``opt_state``, which the step returns,
    so that no second copy of either is made. On a mesh (DTensor tokens)
    each rank splits its own rows, so microbatch i is every rank's i-th
    part (the same sum of gradients, and no tokens move)."""
    def grad_fn(params, tokens):
        return value_and_grad(lambda p: lm_loss(cfg, p, tokens, plan),
                              params)

    def step(params, opt_state, tokens):
        if n_microbatches == 1:
            loss, grads = grad_fn(params, tokens)
        else:
            mb = _microbatches(tokens, n_microbatches)
            loss = None
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            for i in range(n_microbatches):
                li, gi = grad_fn(params, mb[i])
                loss = li if loss is None else loss + li
                # in place on the step's own sums: a + b.to(accum_dtype)
                tree_map(lambda a, b: a.add_(b), grads, gi)
                del gi
            loss = loss / n_microbatches
            tree_map(lambda g: g.div_(n_microbatches), grads)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state, donate=donate)
        return params, opt_state, dict(loss=loss, **metrics)
    return step


def _microbatches(tokens, n: int) -> list:
    """``tokens`` [B, S+1] in ``n`` equal row blocks; a DTensor's split on
    each rank's own rows."""
    from torch.distributed.tensor import DTensor

    if not isinstance(tokens, DTensor):
        B = tokens.shape[0]
        return list(tokens.reshape(n, B // n, tokens.shape[1]))
    local = tokens.to_local()
    parts = local.reshape(n, local.shape[0] // n, local.shape[1])
    return [DTensor.from_local(p, tokens.device_mesh, tokens.placements,
                               run_check=False) for p in parts]


def _zero_shard_spec(spec, shape, dp_axes, dp_size):
    """ZeRO-style: optimizer state also shards its first free (None) dim over
    the DP axes when divisible — moments of a 480B model cannot afford pure
    TP sharding."""
    if len(shape) < 3:
        # embedding-style tables stay TP-sharded; ZeRO targets the stacked
        # [L, ...] layer weights (the reference's rule, kept as it is)
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for ax in (e if isinstance(e, tuple) else (e,)):
            if ax:
                used.add(ax)
    if used & set(dp_axes):
        return spec  # already DP-sharded (e.g. FSDP applied upstream)
    # prefer the LAST divisible free dim: for [L, E, d, ff] weights this
    # shards ff, keeping the d-contraction local per device
    for i in range(len(entries) - 1, -1, -1):
        e, dim = entries[i], shape[i]
        if e is None and dim % dp_size == 0 and dim > 0:
            entries[i] = dp_axes
            return P(*entries)
    return spec


def _auto_microbatches(cfg, B, S, dp_size, budget_bytes=4e9):
    tokens_dev = B * S / dp_size
    resident = tokens_dev * cfg.d_model * 2 * cfg.n_layers
    n = 1
    while resident / n > budget_bytes and n < B:
        n *= 2
    while B % n != 0:
        n //= 2
    return max(n, 1)


def param_shapes(cfg: TransformerConfig) -> dict:
    """``init_params``' tree as :class:`TensorSpec` leaves, traced on fake
    tensors (nothing is drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_params(cfg, torch.Generator(), "cpu")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), params)


def _moment_specs(pshapes, opt_cfg: AdamWConfig) -> dict:
    """``adamw_init``'s tree as :class:`TensorSpec` leaves."""
    if opt_cfg.moments_dtype == "int8":
        mom = tree_map(lambda s: dict(q=TensorSpec(s.shape, torch.int8),
                                      scale=TensorSpec((), torch.float32)),
                       pshapes)
    else:
        dtype = (torch.bfloat16 if opt_cfg.moments_dtype == "bf16"
                 else torch.float32)
        mom = tree_map(lambda s: TensorSpec(s.shape, dtype), pshapes)
    return dict(mu=mom, nu=mom, step=TensorSpec((), torch.int32))


_LONG_500K_REASON = (
    "full (quadratic) GQA attention: 524k-token decode needs "
    "sub-quadratic attention; assigned LM archs are all "
    "full-attention -> noted skip (DESIGN.md §6)")


def make_lm_dryrun_case(cfg: TransformerConfig, shape_name: str, mesh,
                        opt_cfg: AdamWConfig = AdamWConfig(), batch=None,
                        n_microbatches=None, donate: bool = True):
    """The reference's LM dry-run case on ``mesh`` (a ``DeviceMesh``): the
    train step (fwd + bwd + AdamW, microbatched by ``_auto_microbatches``,
    the state donated), the prefill forward, or one decode step against a
    32k cache; ``long_500k`` is a ``SkipCell``. Placements follow
    ``make_lm_plan`` and ``param_specs``, with FSDP (``_zero_shard_spec``
    on the weights) where TP alone leaves more than 4 GB of bf16 weights
    a rank, and ZeRO on the moments always. ``batch``,
    ``n_microbatches`` and ``donate`` override the shape's global batch,
    the microbatch rule and the donation (one card's train step:
    ``CARD_BATCH`` in ``CARD_MICROBATCHES``, not donated, as
    ``chip_smoke.py`` runs it). On a mesh of one rank the step runs with
    the null plan on plain tensors (``launch.dryrun.materialize`` makes no
    DTensor there): a plan on one rank is the null plan's program."""
    dims = SHAPE_DIMS[shape_name]
    name = f"{cfg.name}/{shape_name}"
    if shape_name == "long_500k":
        return SkipCell(name=name, reason=_LONG_500K_REASON)
    plan = make_lm_plan(mesh)
    psp = param_specs(cfg, plan)
    pshapes = param_shapes(cfg)
    if mesh.size() == 1:
        plan = null_plan()
    B, S = batch or dims["global_batch"], dims["seq_len"]
    dp_axes = _dp_axes(mesh)
    dp_size = make_lm_plan(mesh).dp_size()
    tp = make_lm_plan(mesh).axis_size("model")
    fsdp = cfg.param_count() * 2 / tp > 4e9
    if fsdp:
        psp = tree_map(lambda sp, sh: _zero_shard_spec(sp, sh.shape, dp_axes,
                                                       dp_size), psp, pshapes)

    def named(spec):
        return NamedSharding(mesh, spec)

    params_sh = tree_map(named, psp)
    tokens_sh = named(plan.spec("tokens"))
    rep = named(P())

    if dims["kind"] == "train":
        mom_sh = tree_map(lambda sp, sh: named(_zero_shard_spec(
            sp, sh.shape, dp_axes, dp_size)), psp, pshapes)
        if opt_cfg.moments_dtype == "int8":
            mom_sh = tree_map(lambda sh: dict(q=sh, scale=rep), mom_sh)
        opt_sh = dict(mu=mom_sh, nu=mom_sh, step=rep)
        n_mb = n_microbatches or _auto_microbatches(cfg, B, S, dp_size)
        accum = (torch.bfloat16 if cfg.param_count() > 1e11
                 else torch.float32)
        fn = lm_train_step(cfg, plan, opt_cfg, n_microbatches=n_mb,
                           accum_dtype=accum, donate=donate)
        return DryrunCase(
            name=name, fn=fn,
            build_args=lambda: (pshapes, _moment_specs(pshapes, opt_cfg),
                                TensorSpec((B, S + 1), torch.int32)),
            in_placements=(params_sh, opt_sh, tokens_sh),
            out_placements=(params_sh, opt_sh,
                            dict(loss=rep, grad_norm=rep, lr=rep)),
            model_flops=6.0 * cfg.active_param_count() * B * S,
            comment=f"train_step: fwd+bwd+AdamW, {n_mb} microbatch(es), "
                    f"moments={opt_cfg.moments_dtype}")

    if dims["kind"] == "prefill":
        def prefill(params, toks):
            with torch.no_grad():
                return forward(cfg, params, toks, plan)

        return DryrunCase(
            name=name, fn=prefill,
            build_args=lambda: (pshapes, TensorSpec((B, S), torch.int32)),
            in_placements=(params_sh, tokens_sh),
            out_placements=named(plan.spec("logits")),
            model_flops=2.0 * cfg.active_param_count() * B * S,
            comment="serve_step: full prefill")

    # decode: one new token against a seq_len KV cache. KV heads shard over
    # 'model' when divisible (moonshot kv=16); otherwise the head_dim does
    # (arctic kv=8 < tp=16, dh=128 divides); else it is replicated there
    T = dims["seq_len"]
    if cfg.n_kv_heads % tp == 0:
        kv_spec = P(None, dp_axes, None, "model", None)
    elif cfg.d_head % tp == 0:
        kv_spec = P(None, dp_axes, None, None, "model")
    else:
        kv_spec = P(None, dp_axes, None, None, None)
    kv_sh = named(kv_spec)
    cache = TensorSpec((cfg.n_layers, B, T, cfg.n_kv_heads, cfg.d_head),
                       cfg.dtype)

    def decode(params, toks, kv_cache):
        with torch.no_grad():
            return decode_step(cfg, params, toks, kv_cache, T - 1, plan)

    return DryrunCase(
        name=name, fn=decode,
        build_args=lambda: (pshapes, TensorSpec((B, 1), torch.int32),
                            (cache, cache)),
        in_placements=(params_sh, tokens_sh, (kv_sh, kv_sh)),
        out_placements=(named(plan.spec("logits")), (kv_sh, kv_sh)),
        model_flops=2.0 * cfg.active_param_count() * B
        + 2.0 * B * cfg.n_layers * T * cfg.n_kv_heads * cfg.d_head * 2,
        comment="serve_step: single-token decode w/ 32k KV cache")


def make_lm_smoke_case(smoke_cfg: TransformerConfig, device=None):
    """The reference's smoke case on ``smoke_cfg`` (the weights from a
    seeded ``torch.Generator``, tokens [2, 16] from another): one train
    step (AdamW at its defaults) and one ``decode_step`` from an empty
    24-slot cache, on ``device`` (default: the CUDA card). Returns the
    step's loss and the decode's logits."""
    def run():
        dev = resolve_device(device)
        params = init_params(smoke_cfg, torch.Generator().manual_seed(0),
                             dev)
        toks = torch.randint(0, smoke_cfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.int32).to(dev)
        step = lm_train_step(smoke_cfg, null_plan(), AdamWConfig())
        _, _, metrics = step(params, adamw_init(params), toks)
        # also exercise the serve path
        cache = init_kv_cache(smoke_cfg, 2, 24, device=dev)
        with torch.no_grad():
            logits, _ = decode_step(smoke_cfg, params, toks[:, :1], cache, 0)
        return dict(loss=metrics["loss"], logits=logits)
    return run


def register_lm(arch_id: str, cfg: TransformerConfig,
                smoke_cfg: TransformerConfig, describe: str = "",
                opt_cfg: AdamWConfig = AdamWConfig()):
    """Register an LM arch; ``cfg`` and ``opt_cfg`` are what its dry-run
    cases trace."""
    return register(ArchSpec(
        arch_id=arch_id, family="lm", shapes=LM_SHAPES,
        make_dryrun_case=lambda shape, mesh: make_lm_dryrun_case(
            cfg, shape, mesh, opt_cfg),
        make_smoke_case=lambda device=None: make_lm_smoke_case(
            smoke_cfg, device=device),
        describe=describe))
