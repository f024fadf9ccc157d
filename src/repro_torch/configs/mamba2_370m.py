"""mamba2-370m [ssm]: 48L d=1024, attention-free, vocab=50280, state=128.
SSD (state-space duality). [arXiv:2405.21060; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_d_inner=2048,
    ssm_head_dim=64,  # 32 SSD heads
    ssm_conv=4,
    ssm_chunk=256,
    max_context=1_048_576,
    sub_quadratic=True,  # runs long_500k
)
