"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
GQA + RoPE, LayerNorm, plain-GELU MLP. [arXiv:2402.19173; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    layer_pattern=("global",),
    norm="layernorm",
    mlp_act="gelu",
    rope_theta=100_000.0,
    max_context=16384,
)
