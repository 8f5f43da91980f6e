"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; assigned pool]; torch port
of ``repro.configs.qwen2_0p5b``."""

import torch

from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1e6,
    dtype=torch.bfloat16)

SMOKE = TransformerConfig(
    name="qwen2-0.5b-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
    d_ff=112, vocab=173, qkv_bias=True, dtype=torch.float32)

register_lm("qwen2-0.5b", FULL, SMOKE, describe=__doc__)
