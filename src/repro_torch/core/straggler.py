"""Responsive-worker selection — counterpart of ``repro.core.straggler``
(``select_workers``; the latency and membership models come later)."""
from __future__ import annotations

import torch

__all__ = ["select_workers"]


def select_workers(mask: torch.Tensor, R: int) -> torch.Tensor:
    """First R responsive worker indices (stable order). mask: (N,) bool.

    Requires sum(mask) >= R for a valid decode; with fewer responders the
    trailing indices repeat dead workers and the caller must treat the
    result as failed.
    """
    # torch sorts no bool tensors: order by ~mask as 0/1 integers
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    return order[:R]
