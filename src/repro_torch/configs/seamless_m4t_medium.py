"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d=1024 16H (MHA kv=16)
d_ff=4096 vocab=256206.  Encoder-decoder; modality frontend is a STUB —
input_specs provides precomputed frame embeddings. [arXiv:2308.11596; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    layer_pattern=("global",),
    mlp_act="gelu",
    norm="layernorm",
    frontend="frames",
    frontend_dim=1024,
    src_ratio=4,  # src frames = seq_len / 4 (audio downsampling stub)
    max_context=32768,
)
