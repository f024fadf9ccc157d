"""Assigned architecture configs (--arch <id>) + shape cells — a copy of
``repro.configs`` (the ten architectures are data)."""
from .base import SHAPES, ModelConfig, ShapeConfig, smoke_shape
from .deepseek_67b import CONFIG as deepseek_67b
from .gemma2_2b import CONFIG as gemma2_2b
from .gemma3_12b import CONFIG as gemma3_12b
from .internvl2_2b import CONFIG as internvl2_2b
from .kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from .mamba2_370m import CONFIG as mamba2_370m
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .starcoder2_3b import CONFIG as starcoder2_3b
from .zamba2_7b import CONFIG as zamba2_7b

ARCHS = {
    c.name: c
    for c in [
        gemma3_12b,
        starcoder2_3b,
        deepseek_67b,
        gemma2_2b,
        mamba2_370m,
        seamless_m4t_medium,
        qwen3_moe_30b_a3b,
        kimi_k2_1t_a32b,
        zamba2_7b,
        internvl2_2b,
    ]
}

# long_500k requires a sub-quadratic sequence mechanism
LONG_CONTEXT_ARCHS = {k for k, c in ARCHS.items() if c.sub_quadratic}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic archs."""
    out = []
    for a, cfg in ARCHS.items():
        for s, shp in SHAPES.items():
            skipped = s == "long_500k" and a not in LONG_CONTEXT_ARCHS
            if skipped and not include_skipped:
                continue
            out.append((a, s, skipped))
    return out
