"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    layer_pattern=("global",),
    qk_norm=True,
    mlp_act="swiglu",
    num_experts=128,
    experts_per_tok=8,
    expert_d_ff=768,
    rope_theta=1_000_000.0,
    max_context=32768,
)
