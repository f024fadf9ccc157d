"""Optimizers and gradient compression — counterpart of ``repro.optim``:
AdamW and Adafactor over trees of tensors (DTensors under a mesh), int8
error-feedback compression, and ``compressed_psum`` for shard_map bodies."""
from .compression import compress_tree, compressed_psum, dequantize, init_ef, quantize_ef
from .optimizers import (
    OptConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    opt_init,
    opt_state_specs,
    opt_update,
    schedule,
)

__all__ = [
    "OptConfig", "adafactor_init", "adafactor_update", "adamw_init", "adamw_update",
    "clip_by_global_norm", "compress_tree", "compressed_psum", "dequantize", "global_norm",
    "init_ef", "opt_init", "opt_state_specs", "opt_update", "quantize_ef", "schedule",
]
