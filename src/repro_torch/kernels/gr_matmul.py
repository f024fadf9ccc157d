"""Hopper kernel wrapper: planar Galois-ring matmul over GR(2^e, D).

Replaces the Pallas TPU kernel ``src/repro/kernels/gr_matmul.py:_kernel``
(launched by ``gr_matmul_planar``).  The kernel itself is hand-written CUDA
C++ in ``csrc/gr_matmul.cu`` (its header notes the design and what bounds
it); this module validates the operands, launches it on PyTorch's current
stream through ctypes, and counts launches.

Envelope: p = 2, e <= 32, D <= MAX_D = 16 (the reference's).  Towers of at
most two coprime levels cover every D <= 16; the kernel is instantiated for
each such (degrees[0], degrees[1]).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .build import load_library

__all__ = ["MAX_D", "counters", "gr_matmul_planar", "tower_shape", "kernel_tile"]

MAX_D = 16


class KernelCounters:
    """Plain counts that let a run show it went through the kernel.

    ``launches``: kernel launches by :func:`gr_matmul_planar`.
    ``ref_calls``: CUDA ring matmuls that went to the plain version because
    the ring lies outside the kernel's envelope.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.ref_calls = 0


counters = KernelCounters()


def tower_shape(ring) -> Tuple[int, int]:
    """(D0, D1): the kernel's template parameters for ``ring``."""
    deg = ring.degrees
    if len(deg) > 2:
        raise ValueError(f"{ring}: the kernel takes towers of at most two levels")
    return (deg[0] if deg else 1, deg[1] if len(deg) == 2 else 1)


def kernel_tile(ring) -> Tuple[int, int, int]:
    """(BM, BN, BK) of the kernel instantiation for ``ring``; mirrors the
    ``Cfg`` template in ``csrc/gr_matmul.cu`` (checked against the built
    library by ``chip_smoke.py``)."""
    D, K = ring.D, ring.K
    tm = next((t for t in (4, 2) if K * t * t + 2 * D * t <= 128), 1)
    bm = 16 * tm
    bk = 16 if 2 * D * bm * 16 * 4 <= 48 * 1024 else 8
    return bm, bm, bk


@lru_cache(maxsize=None)
def _check_layout(ring) -> np.ndarray:
    """The kernel hard-codes conv positions from the tower shape; make sure
    the ring's CONVPOS is that layout.  Returns FOLD as (K*D,) uint32."""
    d0, _ = tower_shape(ring)
    i = np.arange(ring.D)[:, None]
    j = np.arange(ring.D)[None, :]
    expect = (i // d0 + j // d0) * (2 * d0 - 1) + (i % d0 + j % d0)
    if not np.array_equal(expect, ring.CONVPOS):
        raise ValueError(f"{ring}: CONVPOS does not match the kernel's tower layout")
    return np.ascontiguousarray(ring.FOLD_U32.reshape(-1))


def _check_operand(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (uint32 bit patterns), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gr_matmul_planar(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Planar GR matmul on the card: A (b, D, T, R), B (b, D, R, S) ->
    C (b, D, T, S); the batch axis b is optional (then 3-D in, 3-D out).

    Launches the CUDA kernel or raises; it never falls back.
    """
    if ring.p != 2 or ring.e > 32:
        raise ValueError("kernel supports the machine-word case p=2, e<=32")
    if ring.D > MAX_D:
        raise ValueError(f"D={ring.D} > MAX_D={MAX_D}; use the plain version")
    squeeze = A.dim() == 3
    if squeeze:
        A, B = A.unsqueeze(0), B.unsqueeze(0)
    if A.dim() != 4 or B.dim() != 4:
        raise ValueError(f"expected (b, D, T, R) x (b, D, R, S), got {A.shape} x {B.shape}")
    nb, D, T, R = A.shape
    nb2, D2, R2, S = B.shape
    if (nb, D, R) != (nb2, D2, R2) or D != ring.D:
        raise ValueError(f"shape mismatch {tuple(A.shape)} x {tuple(B.shape)} for {ring}")
    _check_operand(A, "A")
    _check_operand(B, "B")
    if A.device != B.device:
        raise ValueError(f"A on {A.device}, B on {B.device}")
    fold = _check_layout(ring)
    if -(-T // kernel_tile(ring)[0]) > 65535 or nb > 65535 or max(T, R, S) >= 2**31 - 256:
        raise ValueError(f"shape {tuple(A.shape)} x {tuple(B.shape)} exceeds the launch grid")
    C = torch.empty((nb, D, T, S), dtype=torch.int32, device=A.device)
    if C.numel() == 0:
        return C[0] if squeeze else C
    lib = load_library()
    d0, d1 = tower_shape(ring)
    mask = (2**ring.e - 1) if ring.e < 32 else 0xFFFFFFFF
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gr_matmul_planar_u32(
            A.data_ptr(), B.data_ptr(), C.data_ptr(), nb, T, R, S, d0, d1,
            fold.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), mask, stream,
        )
    if err != 0:
        raise RuntimeError(f"gr_matmul kernel launch failed: cudaError {err}")
    counters.launches += 1
    return C[0] if squeeze else C
