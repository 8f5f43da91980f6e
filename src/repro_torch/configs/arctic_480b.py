"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base;
assigned pool]; torch port of ``repro.configs.arctic_480b``. Arctic's
signature is the dense-FFN + MoE *parallel residual*
(``dense_residual=True``)."""

import torch

from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import MoEConfig, TransformerConfig
from repro_torch.optim.adamw import AdamWConfig

FULL = TransformerConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, qkv_bias=False, rope_theta=1e4,
    dtype=torch.bfloat16,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True, capacity_factor=1.25))

SMOKE = TransformerConfig(
    name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=199, dtype=torch.float32,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, dense_residual=True))

# 480B params: f32 Adam moments alone are 3.8 TB; int8 (8-bit-Adam) states
# are what makes the training cell fit pod HBM
OPT_CFG = AdamWConfig(moments_dtype="int8")

register_lm("arctic-480b", FULL, SMOKE, describe=__doc__, opt_cfg=OPT_CFG)
