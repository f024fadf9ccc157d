"""Config schema: model architecture + input-shape cells — a copy of
``repro.configs.base`` whose ``adtype`` is a ``torch.dtype``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    layer_pattern: Tuple[str, ...] = ("global",)  # repeating unit of local/global
    window_size: int = 4096
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    expert_d_ff: int = 0
    shared_experts: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0

    # enc-dec
    encoder_layers: int = 0
    src_ratio: int = 1  # src_len = seq_len // src_ratio

    # modality stub frontend
    frontend: Optional[str] = None  # "patch" | "frames"
    frontend_dim: int = 0
    frontend_len: int = 0  # fixed token count for patches

    # numerics / training
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    max_context: int = 131072
    sub_quadratic: bool = False  # can run long_500k

    # distribution / memory plan
    fsdp_axes: Tuple[str, ...] = ("data",)  # weight-shard axes (ZeRO-3)
    optimizer: str = "adamw"  # adamw | adafactor
    opt_state_dtype: str = "float32"
    grad_accum: int = 1  # microbatch accumulation (memory, not comms)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def adtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        if self.shared_attn_every:
            smoke_every = min(self.shared_attn_every, 2)
            nl = 2 * smoke_every + 1  # 2 units + a tail layer
        else:
            nl = max(2, len(self.layer_pattern)) + self.first_k_dense
            rem = (nl - self.first_k_dense) % len(self.layer_pattern)
            if rem:
                nl += len(self.layer_pattern) - rem
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=nl,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            experts_per_tok=min(self.experts_per_tok, 2) if self.experts_per_tok else 0,
            expert_d_ff=64 if self.expert_d_ff else 0,
            ssm_state=32 if self.ssm_state else 0,
            ssm_d_inner=256 if self.ssm_d_inner else 0,
            ssm_head_dim=32,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_dim=64 if self.frontend_dim else 0,
            frontend_len=8 if self.frontend_len else 0,
            window_size=min(self.window_size, 64),
            shared_attn_every=min(self.shared_attn_every, 2) or 0,
            max_context=2048,
            first_k_dense=min(self.first_k_dense, 1),
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return ShapeConfig(f"smoke_{kind}", 64, 2, kind)
