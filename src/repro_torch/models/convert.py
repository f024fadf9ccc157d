"""Weight and cache conversion: a parameter or cache tree as numpy arrays
(the reference's trees after ``np.asarray`` on each leaf) into the port's
tensor tree, bit for bit.

bf16 leaves arrive as numpy arrays of ``ml_dtypes``' bfloat16; they are
carried as their 16-bit patterns, so neither numpy nor the port needs
``ml_dtypes`` itself.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from ..runtime.sharding import _map_leaves

__all__ = ["cache_from_numpy", "params_from_numpy"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the reference's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.kind not in "fiub":
        raise TypeError(f"cannot convert a leaf of dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """The reference's parameter tree (numpy leaves) as tensors on ``device``
    (default: the card), same paths, same dtypes, same bits."""
    device = resolve_device(device)
    return _map_leaves(lambda _, a: _tensor(a, device), tree)


def cache_from_numpy(tree: Dict, device=None) -> Dict:
    """A cache tree (from the reference's ``cache_decl``) as tensors on
    ``device``; its scalar ``"len"`` becomes a Python int, the number of
    tokens the host has written."""
    device = resolve_device(device)
    return {k: int(np.asarray(v)) if k == "len" else _map_leaves(lambda _, a: _tensor(a, device), v)
            for k, v in tree.items()}
