"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE [arXiv:2402.19173; assigned pool]; torch port of
``repro.configs.starcoder2_3b``."""

import torch

from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
    n_kv_heads=2, d_ff=12288, vocab=49152, qkv_bias=False, rope_theta=1e5,
    dtype=torch.bfloat16)

SMOKE = TransformerConfig(
    name="starcoder2-3b-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, d_ff=192, vocab=211, dtype=torch.float32)

register_lm("starcoder2-3b", FULL, SMOKE, describe=__doc__)
