"""Shared LM-family machinery: torch port of ``repro.configs.lm_common``
(the four assigned shapes, the train step with microbatches, the
microbatch rule, the smoke case and the registration), less the dry-run
case (``make_lm_dryrun_case``, ``_zero_shard_spec`` and ``long_500k``'s
``SkipCell``: ROADMAP A16).

LM shapes (assigned): train_4k, prefill_32k, decode_32k, long_500k. All
the assigned LM archs use full (quadratic) GQA attention, so
``long_500k`` (a 524,288-token decode) is a noted skip of the dry-run.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ArchSpec, register
from repro_torch.device import resolve_device
from repro_torch.models.sharding import null_plan
from repro_torch.models.transformer import (TransformerConfig, decode_step,
                                            init_kv_cache, init_params,
                                            lm_loss)
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
    so that no second copy of either is made."""
    def grad_fn(params, tokens):
        return value_and_grad(lambda p: lm_loss(cfg, p, tokens, plan),
                              params)

    def step(params, opt_state, tokens):
        if n_microbatches == 1:
            loss, grads = grad_fn(params, tokens)
        else:
            B = tokens.shape[0]
            mb = tokens.reshape(n_microbatches, B // n_microbatches,
                                tokens.shape[1])
            loss = torch.zeros((), device=tokens.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            for i in range(n_microbatches):
                li, gi = grad_fn(params, mb[i])
                loss = loss + li
                # in place on the step's own sums: a + b.to(accum_dtype)
                tree_map(lambda a, b: a.add_(b), grads, gi)
                del gi
            loss = loss / n_microbatches
            tree_map(lambda g: g.div_(n_microbatches), grads)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state, donate=donate)
        return params, opt_state, dict(loss=loss, **metrics)
    return step


def _auto_microbatches(cfg, B, S, dp_size, budget_bytes=4e9):
    tokens_dev = B * S / dp_size
    resident = tokens_dev * cfg.d_model * 2 * cfg.n_layers
    n = 1
    while resident / n > budget_bytes and n < B:
        n *= 2
    while B % n != 0:
        n //= 2
    return max(n, 1)


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
    case will lower (ROADMAP A16)."""
    return register(ArchSpec(
        arch_id=arch_id, family="lm", shapes=LM_SHAPES,
        make_smoke_case=lambda device=None: make_lm_smoke_case(
            smoke_cfg, device=device),
        describe=describe))
