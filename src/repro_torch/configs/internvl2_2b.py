"""internvl2-2b [vlm]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
InternViT frontend is a STUB — input_specs provides precomputed patch
embeddings (256 tokens x 1024). [arXiv:2404.16821; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    layer_pattern=("global",),
    mlp_act="swiglu",
    frontend="patch",
    frontend_dim=1024,
    frontend_len=256,
    max_context=32768,
)
