"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384 experts top-8 + 1 shared expert, first layer dense.
Trillion-parameter MoE (paper-table). [arXiv:2501.kimi2; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=14336,  # used by the first dense layer
    vocab_size=163840,
    layer_pattern=("global",),
    mlp_act="swiglu",
    num_experts=384,
    experts_per_tok=8,
    expert_d_ff=2048,
    shared_experts=1,
    first_k_dense=1,
    rope_theta=50_000.0,
    max_context=131072,
    # 1T params: ZeRO-3 across pod+data, factored optimizer states — the only
    # plan that fits 2 TB of bf16 params + grads in 512 x 16 GB (see
    # EXPERIMENTS.md §Dry-run for the measured bytes/device)
    fsdp_axes=("pod", "data"),
    optimizer="adafactor",
    opt_state_dtype="bfloat16",
    # grad_accum=16 was REFUTED (iter K3): ZeRO-3 weight re-gathers per
    # microbatch blew collective time 15x; SP-residual (K4) solves the
    # activation memory instead.
)
