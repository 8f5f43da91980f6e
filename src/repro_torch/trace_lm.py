"""Where the time of an LM training step goes on the card.

    python -m repro_torch.trace_lm [--trace-dir DIR]

For qwen2-0.5b's ``FULL`` config, then moonshot-v1-16b-a3b's at ``FULL``
widths and ``lm_common.MOE_CARD_LAYERS`` (4) layers: builds the weights
from a seeded generator and AdamW with float32 moments, and one batch of
``train_4k``'s sequence (4,096 tokens; ``lm_batch_stream``) at the card's
batch (``lm_common``'s ``CARD_BATCH``, 16, in ``CARD_MICROBATCHES``, 4;
``MOE_CARD_BATCH``, 8, in ``MOE_CARD_MICROBATCHES``, 8, for the MoE, its
step and AdamW donated), and profiles, with ``trace_solve.profile_call``,
one warm training step (``lm_train_step``), then its parts alone, each at
one microbatch: the forward (``forward``: ``lm_loss`` without a graph),
the loss and gradients (``grads``), one layer's attention forward and
backward (``attention``: ``gqa_attention`` on seeded q, k, v; the step
runs it twice forward, under remat, and once backward a layer and
microbatch), for the MoE one layer's ``moe_ffn`` forward and backward on
a seeded hidden state (``moe_ffn``), the final norm, ``lm_head`` and the
loss forward and backward on a seeded hidden state (``head_loss``), and
AdamW (``adamw``). For each: the untraced wall time, device time by kernel
name, the number of launches and the device's busy share; the device time
and launches summed by group: the matrix products (``gemm``: cuBLAS), the
softmax kernels (``softmax``), the reductions (``reduce``: RMSNorm's
variance, the log-sum-exp, AdamW's norm), the elementwise passes
(``elementwise``: casts, the causal mask, RoPE, SiLU, the
residual adds, AdamW), the embedding's gather and its gradient
(``embedding``) and the rest (``other``: concatenations, copies, the
gold logit's gather and scatter), for the MoE with the routing, dispatch
and combine first (``dispatch_combine``, ``MOE_GROUPS``); and each
part's peak memory (GiB). ``--trace-dir`` writes one Chrome trace per
part. Prints one JSON object, one entry per arch. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

# device kernels by group, by a part of the name the profiler reports
# (first match wins; everything else is "other")
LM_GROUPS = (("gemm", ("gemm", "gemv", "xmma", "cutlass", "sm90_xmma",
                       "nvjet")),
             ("softmax", ("softmax", "SoftMax")),
             ("embedding", ("embedding",)),
             ("reduce", ("reduce_kernel",)),
             ("elementwise", ("elementwise_kernel",)))


# the MoE step's groups: its routing, dispatch and combine first (the sort
# of each token's router probabilities, the one-hot's scatter and the
# positions' cumsum and gather, the index writes and reads of the expert
# buffer; the loss's gold-logit gather and its gradient land here too)
MOE_GROUPS = (("dispatch_combine", ("SortKVInPlace", "index_elementwise",
                                    "indexSelect", "index_put", "scan",
                                    "Scan", "scatter_gather")),) + LM_GROUPS


def lm_groups(kernels, groups=LM_GROUPS) -> dict:
    """``{group: total}`` of ``(kernel name, ms or launches)`` pairs."""
    out = {}
    for name, x in kernels:
        group = next((g for g, parts in groups
                      if any(p in name for p in parts)), "other")
        out[group] = round(out.get(group, 0) + x, 4)
    return out


def trace_arch(torch, cfg, batch, n_mb, opt_cfg, groups, trace_dir,
               donate=False) -> dict:
    """One warm step of ``cfg`` at ``batch`` × train_4k's 4,096 tokens in
    ``n_mb`` microbatches and its parts (see the module docstring), each
    profiled, its kernels summed by ``groups``."""
    from repro_torch.configs.lm_common import SHAPE_DIMS, lm_train_step
    from repro_torch.data.synthetic import lm_batch_stream
    from repro_torch.models.sharding import null_plan
    from repro_torch.models.transformer import (cross_entropy, gqa_attention,
                                                init_params, lm_loss,
                                                moe_ffn, rms_norm)
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from repro_torch.trace_solve import profile_call
    from repro_torch.tree import tree_map, value_and_grad

    dev = torch.device("cuda")
    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    mb = batch // n_mb
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    opt = adamw_init(params, opt_cfg)
    tokens = torch.as_tensor(next(lm_batch_stream(
        cfg.vocab, batch, seq))[1], device=dev)
    step = lm_train_step(cfg, null_plan(), opt_cfg, n_microbatches=n_mb,
                         donate=donate)

    def loss(p):
        return lm_loss(cfg, p, tokens[:mb])

    _, grads = value_and_grad(loss, params)
    grads = tree_map(lambda g: g.float(), grads)   # as the step accumulates

    def forward():
        with torch.no_grad():
            return loss(params)

    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = (torch.randn((mb, seq, h, dh), generator=gen, device=dev)
               .to(cfg.dtype).requires_grad_() for h in (H, Hkv, Hkv))
    d_att = torch.randn((mb, seq, H, dh), generator=gen,
                        device=dev).to(cfg.dtype)

    def attention():
        out = gqa_attention(q, k, v, causal_offset=0, q_chunk=cfg.q_chunk)
        return torch.autograd.grad(out, (q, k, v), d_att)

    hidden = torch.randn((mb, seq, cfg.d_model), generator=gen,
                         device=dev).to(cfg.dtype).requires_grad_()
    head = {k: params[k] for k in ("final_norm", "lm_head")}

    def head_loss_fn(hp):
        x = rms_norm(hidden, hp["final_norm"], cfg.norm_eps)
        return cross_entropy(torch.matmul(x, hp["lm_head"]), tokens[:mb, 1:])

    parts = dict(step=lambda: step(params, opt, tokens), forward=forward,
                 grads=lambda: value_and_grad(loss, params),
                 attention=attention)
    if cfg.moe is not None:
        layer0 = {k: params[k][0].detach().requires_grad_()
                  for k in ("router", "moe_gate", "moe_up", "moe_down",
                            "shared_gate", "shared_up", "shared_down")
                  if k in params}

        def moe():
            out = moe_ffn(hidden, layer0, cfg.moe, null_plan())
            return torch.autograd.grad(out, [hidden, *layer0.values()],
                                       hidden.detach())

        parts["moe_ffn"] = moe
    parts.update(head_loss=lambda: value_and_grad(head_loss_fn, head),
                 adamw=lambda: adamw_update(opt_cfg, params, grads, opt,
                                            donate=donate))
    flop = 6.0 * cfg.active_param_count() * batch * seq
    out = dict(arch=cfg.name, layers=cfg.n_layers, batch=batch,
               microbatches=n_mb, seq=seq, model_flop_per_step=flop)
    for part, fn in parts.items():
        path = (f"{trace_dir}/lm_{cfg.name}_{part}.json"
                if trace_dir else None)
        torch.cuda.reset_peak_memory_stats()
        res = profile_call(torch, fn, path, top=1000)[1]
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["groups_ms"] = lm_groups(
            [(k["name"], k["ms"]) for k in res["top_kernels"]], groups)
        res["groups_launches"] = lm_groups(
            [(k["name"], k["count"]) for k in res["top_kernels"]], groups)
        res["top_kernels"] = res["top_kernels"][:12]
        out[part] = res
    return out


def main(argv=None) -> int:
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import moonshot_v1_16b_a3b, qwen2_0p5b
    from repro_torch.configs.lm_common import (CARD_BATCH, CARD_MICROBATCHES,
                                               MOE_CARD_BATCH,
                                               MOE_CARD_LAYERS,
                                               MOE_CARD_MICROBATCHES)
    from repro_torch.optim.adamw import AdamWConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="directory for one Chrome trace per part")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_lm: needs a CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    out = dict(device=torch.cuda.get_device_name(0))
    out[qwen2_0p5b.FULL.name] = trace_arch(
        torch, qwen2_0p5b.FULL, CARD_BATCH, CARD_MICROBATCHES, opt_cfg,
        LM_GROUPS, args.trace_dir)
    gc.collect()
    torch.cuda.empty_cache()
    moon = dataclasses.replace(moonshot_v1_16b_a3b.FULL,
                               n_layers=MOE_CARD_LAYERS)
    out[moon.name] = trace_arch(
        torch, moon, MOE_CARD_BATCH, MOE_CARD_MICROBATCHES, opt_cfg,
        MOE_GROUPS, args.trace_dir, donate=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
