"""Gradient compression — counterpart of ``repro.optim.compression``: int8
quantization with error feedback (EF-SGD style), applied to a gradient tree
as quantize -> dequantize with a persistent float32 error-feedback buffer
(the train step's path, on DTensors under a mesh), plus ``compressed_psum``,
the int8-payload mean over a mesh axis for ``shard_map`` bodies, which
actually moves the int8 values and their float32 scales across the axis.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .optimizers import _div, _zip_map

__all__ = ["compress_tree", "compressed_psum", "dequantize", "init_ef", "quantize_ef"]


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
    return _zip_map(lambda g: torch.zeros_like(g, dtype=torch.float32,
                                                memory_format=torch.contiguous_format),
                    grads_like)


def compressed_psum(g: torch.Tensor, ef: torch.Tensor, axis: str, mesh=None):
    """int8-payload mean across the mesh ``axis`` (inside a ``shard_map``
    body; ``mesh`` defaults to the ``axis_rules`` one).

    Each rank quantizes ``g + ef`` (``quantize_ef``), the int8 values and
    the float32 scales are all-gathered, and every rank dequantizes them
    exactly: ``tensordot(scales, qs) / n``, the reference's order.  The
    reference's int32 ``psum`` and scale ``pmax`` are dead code there (their
    results are deleted) and are not issued.  Returns (mean, new_ef)."""
    from ..runtime import collectives as coll
    from ..runtime.sharding import current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    q, scale, new_ef = quantize_ef(g, ef)
    n = coll.axis_size(mesh, axis)
    scales = coll.all_gather(scale, mesh, axis)  # (n,)
    qs = coll.all_gather(q, mesh, axis)  # (n, ...): exact dequantization
    mean = _div(torch.tensordot(scales, qs.float(), dims=([0], [0])), n)
    return mean, new_ef
