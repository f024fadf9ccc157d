"""Dispatch around the Galois-ring matmul kernel.

Counterpart of ``repro.kernels.ops``: converts between the interleaved
(t, r, D) and planar (D, t, r) layouts and picks the path.  Every ring
matmul of the port comes through :func:`gr_matmul`:

* CPU tensors take the plain PyTorch version (``ref.gr_matmul_ref``);
* CUDA tensors of a ring inside the envelope (``kernel_supported``) launch
  the hand-written kernel, or raise;
* CUDA tensors of a ring outside it take the plain version, decided before
  any launch as the reference decides (``repro/kernels/ops.py:66``), and are
  counted in ``counters.ref_calls``.

The kernel masks ragged edges itself, so no operand is padded here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .gr_matmul import MAX_D, counters, gr_matmul_planar, kernel_tile
from .ref import gr_matmul_ref

__all__ = [
    "gr_matmul",
    "coded_encode",
    "kernel_supported",
    "kernel_auto_enabled",
    "pick_blocks",
]


def pick_blocks(ring) -> Tuple[int, int, int]:
    """(bt, bs, br) the kernel uses for ``ring``: a static choice from the
    ring's K and D (an autotuner is later work)."""
    return kernel_tile(ring)


def kernel_supported(ring) -> bool:
    return ring.p == 2 and ring.e <= 32 and ring.D <= MAX_D


def kernel_auto_enabled(ring, x: torch.Tensor) -> bool:
    """True when a ring matmul on ``x`` goes to the kernel: the tensor is
    on CUDA and the ring is inside the envelope."""
    return x.is_cuda and kernel_supported(ring)


def gr_matmul(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Ring matmul (..., t, r, D) x (..., r, s, D) -> (..., t, s, D).

    Up to one leading batch axis, shared by A and B (one launch for all).
    """
    if A.shape[-1] != ring.D or B.shape[-1] != ring.D or A.shape[-2] != B.shape[-3]:
        raise ValueError(f"shape mismatch {tuple(A.shape)} x {tuple(B.shape)} for {ring}")
    if A.dim() != B.dim() or A.dim() not in (3, 4) or A.shape[:-3] != B.shape[:-3]:
        raise ValueError(f"expected matching (b?, t, r, D) x (b?, r, s, D), got "
                         f"{tuple(A.shape)} x {tuple(B.shape)}")
    if A.device != B.device:
        raise ValueError(f"A on {A.device}, B on {B.device}")
    if kernel_auto_enabled(ring, A):
        Ap = A.movedim(-1, -3).contiguous()
        Bp = B.movedim(-1, -3).contiguous()
        return gr_matmul_planar(Ap, Bp, ring).movedim(-3, -1)
    if A.is_cuda:
        counters.ref_calls += 1
    return gr_matmul_ref(A, B, ring)


def coded_encode(V: torch.Tensor, blocks_mat: torch.Tensor, ring) -> torch.Tensor:
    """CDMM encode = ring matmul against a Vandermonde slice.

    V: (N, K, D); blocks_mat: (K, M, D) -> (N, M, D)."""
    return gr_matmul(V, blocks_mat, ring)
