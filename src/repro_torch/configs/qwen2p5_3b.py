"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5-3B; assigned pool]; torch
port of ``repro.configs.qwen2p5_3b``."""

import torch

from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1e6,
    dtype=torch.bfloat16)

SMOKE = TransformerConfig(
    name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=251, qkv_bias=True, dtype=torch.float32)

register_lm("qwen2.5-3b", FULL, SMOKE, describe=__doc__)
