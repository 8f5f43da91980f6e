"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 [hf:moonshotai/Moonlight-16B-A3B;
assigned pool]; torch port of ``repro.configs.moonshot_v1_16b_a3b``.
DeepSeek-lineage: fine-grained experts + 2 shared experts. (The assigned
48L/64e numbers give ~29B total / ~4.8B active with this parameterisation;
the assigned numbers are followed verbatim.)"""

import torch

from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=163840, qkv_bias=False, rope_theta=5e4,
    dtype=torch.bfloat16,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25))

SMOKE = TransformerConfig(
    name="moonshot-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=157, dtype=torch.float32,
    moe=MoEConfig(n_experts=8, top_k=3, d_ff_expert=32, n_shared=1))

register_lm("moonshot-v1-16b-a3b", FULL, SMOKE, describe=__doc__)
