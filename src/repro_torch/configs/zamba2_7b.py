"""zamba2-7b [hybrid]: 81L (Mamba2) d=3584, shared attention block
(32H MHA kv=32, d_ff=14336) applied every 6 SSM layers, ssm_state=64,
vocab=32000. [arXiv:2411.15242; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    mlp_act="geglu",
    ssm_state=64,
    ssm_d_inner=7168,
    ssm_head_dim=64,  # 112 SSD heads
    ssm_conv=4,
    shared_attn_every=6,  # 13 shared-attn applications + 3 tail SSM layers
    max_context=1_048_576,
    sub_quadratic=True,  # SSM backbone; shared attn is O(S) per decode step
)
