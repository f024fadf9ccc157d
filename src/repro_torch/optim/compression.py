"""Gradient compression — counterpart of ``repro.optim.compression``: int8
quantization with error feedback (EF-SGD style), applied to a gradient tree
as quantize -> dequantize with a persistent float32 error-feedback buffer.

The reference's ``compressed_psum`` (an int8-payload all-reduce inside
``shard_map``) belongs to its shard_map pipeline and waits with it (ROADMAP
Queue 1 item 7.5).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .optimizers import _div, _zip_map

__all__ = ["compress_tree", "dequantize", "init_ef", "quantize_ef"]


def quantize_ef(
    g: torch.Tensor, ef: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 quantize (g + ef); returns (q, scale, new_ef)."""
    x = g.float() + ef
    amax = x.abs().amax()
    scale = torch.where(amax > 0, _div(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_ef = x - q.float() * scale
    return q, scale, new_ef


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, ef_tree):
    """Quantize-dequantize every leaf with error feedback; returns
    (dequantized grads, new error feedback)."""
    if isinstance(grads, dict):
        pairs = {k: compress_tree(grads[k], ef_tree[k]) for k in grads}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    q, s, new_ef = quantize_ef(grads, ef_tree)
    return dequantize(q, s), new_ef


def init_ef(grads_like):
    return _zip_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)
