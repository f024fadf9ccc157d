"""Parameter declaration for the LM plane — counterpart of
``repro.runtime.sharding``, the part one card needs.

Params are declared as ``ParamSpec`` trees (shape, logical axes, init):
nested dicts whose leaves are specs, walked in the reference's order, so
that ``materialize`` turns the same declaration into tensors and
``param_count``/``param_bytes`` size it without allocating.  The logical
axis names are kept for the mesh slice; ``spec_for``, ``shape_structs``,
``sharding_tree`` and ``axis_rules`` wait for it (ROADMAP Queue 1 item 7.6).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core.galois import fold_in
from ..device import resolve_device

__all__ = ["PIECEWISE_BYTES", "ParamSpec", "materialize", "param_bytes", "param_count", "shard"]

# a leaf whose float32 draw would take more bytes than this is drawn one
# leading slice at a time: qwen3-moe-30b-a3b's stacked experts are 38.7 GB
# each in float32 (48 slices of 805 MB), while every gemma2-2b leaf, the
# largest its 2.36 GB embedding, is drawn whole
PIECEWISE_BYTES = 4 << 30


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Sharding constraint by logical names: the identity.  The reference's
    is a no-op outside an ``axis_rules`` mesh context too, and the port has
    no mesh yet."""
    return x


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical {self.logical} differ in rank")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _map_leaves(fn: Callable[[Tuple[str, ...], Any], Any], tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def _path_seed(seed: int, path: Tuple[str, ...]) -> int:
    """The leaf's generator seed: ``fold_in(seed, h)`` with the reference's
    md5 hash ``h`` of the ``/``-joined path."""
    h = int.from_bytes(hashlib.md5("/".join(path).encode()).digest()[:4], "little")
    return fold_in(seed, h)


def materialize(spec_tree, seed: int, device=None):
    """Instantiate real tensors on ``device`` (default: the card).

    Each ``normal``/``embed`` leaf draws from its own ``torch.Generator`` on
    ``device``, seeded from ``seed`` and the leaf's path.  The distribution
    is the reference's, with its std rule kept as it is: ``scale /
    sqrt(shape[0])``, which for a stacked (U, d, n) leaf is 1/sqrt(U), not
    1/sqrt(d).  The bits are not threefry's, and CPU and CUDA streams differ.

    A leaf whose float32 draw would exceed ``PIECEWISE_BYTES`` is drawn one
    leading slice at a time into the output (slice i from a generator
    seeded ``fold_in(leaf seed, i)``, again by slices if one is still too
    large), so no float32 temporary is larger than a slice.
    """
    device = resolve_device(device)

    def draw(shape, gseed: int, std: float, dtype, out=None):
        if 4 * int(np.prod(shape)) > PIECEWISE_BYTES and len(shape) > 1:
            if out is None:
                out = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                draw(shape[1:], fold_in(gseed, i), std, dtype, out[i])
            return out
        g = torch.Generator(device=device)
        g.manual_seed(gseed)
        x = torch.randn(shape, generator=g, dtype=torch.float32, device=device).mul_(std)
        return x.to(dtype) if out is None else out.copy_(x)

    def init_one(path, ps: ParamSpec):
        if ps.init == "zeros":
            return torch.zeros(ps.shape, dtype=ps.dtype, device=device)
        if ps.init == "ones":
            return torch.ones(ps.shape, dtype=ps.dtype, device=device)
        fan_in = ps.shape[0] if len(ps.shape) >= 1 else 1
        std = ps.scale / np.sqrt(max(fan_in, 1))
        if ps.init == "embed":
            std = ps.scale
        return draw(ps.shape, _path_seed(seed, path), float(std), ps.dtype)

    return _map_leaves(init_one, spec_tree)


def param_count(spec_tree) -> int:
    return sum(int(np.prod(ps.shape)) for _, ps in _leaf_paths(spec_tree))


def param_bytes(spec_tree) -> int:
    return sum(int(np.prod(ps.shape)) * ps.dtype.itemsize for _, ps in _leaf_paths(spec_tree))
