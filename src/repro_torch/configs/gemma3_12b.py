"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local:global attention, 128k context. [hf:google/gemma-3; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local",) * 5 + ("global",),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="geglu",
    max_context=131072,
    sub_quadratic=False,  # sliding windows but 1:6 layers are full attention
)
