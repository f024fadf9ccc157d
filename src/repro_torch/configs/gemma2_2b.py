"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local/global alternating attention, logit softcaps. [arXiv:2408.00118; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp_act="geglu",
    max_context=8192,
)
