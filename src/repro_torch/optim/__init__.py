"""Optimizers and gradient compression — counterpart of ``repro.optim``
(``compressed_psum`` waits for the shard_map pipeline, ROADMAP Queue 1 item
7.5)."""
from .compression import compress_tree, dequantize, init_ef, quantize_ef
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
    "clip_by_global_norm", "compress_tree", "dequantize", "global_norm", "init_ef",
    "opt_init", "opt_state_specs", "opt_update", "quantize_ef", "schedule",
]
