"""Plain PyTorch version of the Galois-ring matmul (the kernel's yardstick).

Written from the ring's definition, not from the kernel's tiles: for every
coefficient pair (i, j) the integer product ``A[i] @ B[j]`` is added into
conv plane ``CONVPOS[i, j]``, then ``out[d] = sum_c FOLD[c, d] * conv[c]``.

Only integer ops that exist on both CPU and CUDA are used, so the same
function is the CPU path of the tests and the card-side reference of
``chip_smoke.py``.  CUDA has no integer matmul, so each product is a chunked
broadcast-multiply in int64 followed by a sum.  For the p = 2, e <= 32
storage (int32 bit patterns) the operands are sign-extended to int64: the
product of two signed 32-bit values is below 2^62, and its low 32 bits are
those of the unsigned product, so ``& 0xFFFFFFFF`` after each multiply keeps
every sum exact.
"""
from __future__ import annotations

import torch

__all__ = ["gr_matmul_ref", "gr_matmul_planar_ref", "to_i32", "u32_to_signed"]

_U32 = 0xFFFFFFFF
# int64 elements of one broadcast-multiply chunk (2^26 * 8 B = 512 MiB)
_CHUNK_ELEMS = 1 << 26


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int32 holding the low 32 bits (exact, no overflow)."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def u32_to_signed(v: int) -> int:
    """A uint32 value as the signed int32 with the same bits."""
    v &= _U32
    return v - (1 << 32) if v >= (1 << 31) else v


def _reduce(x: torch.Tensor, ring) -> torch.Tensor:
    return x & _U32 if ring.p2fast else x % ring.q


def _dot(a: torch.Tensor, b: torch.Tensor, ring) -> torch.Tensor:
    """(..., t, r) @ (..., r, s) -> (..., t, s) int64, reduced mod 2^32 / q."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    *batch, t, r = a.shape
    s = b.shape[-1]
    nb = 1
    for x in batch:
        nb *= x
    chunk = max(1, _CHUNK_ELEMS // max(1, nb * t * s))
    acc = torch.zeros((*batch, t, s), dtype=torch.int64, device=a.device)
    for k0 in range(0, r, chunk):
        prod = a64[..., :, k0 : k0 + chunk, None] * b64[..., None, k0 : k0 + chunk, :]
        acc += _reduce(prod, ring).sum(dim=-2)
        acc = _reduce(acc, ring)
    return acc


def gr_matmul_planar_ref(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Planar layout: (..., D, t, r) x (..., D, r, s) -> (..., D, t, s)."""
    D, K = ring.D, ring.K
    assert A.shape[-3] == B.shape[-3] == D and A.shape[-1] == B.shape[-2]
    conv = [None] * K
    for i in range(D):
        for j in range(D):
            c = int(ring.CONVPOS[i, j])
            p = _dot(A[..., i, :, :], B[..., j, :, :], ring)
            conv[c] = p if conv[c] is None else conv[c] + p
    planes = []
    for d in range(D):
        acc = None
        for c in range(K):
            f = int(ring.FOLD_U32[c, d])
            if f == 0:
                continue
            if ring.p2fast:
                # signed 32-bit lift of both factors: |product| < 2^62
                term = (to_i32(conv[c]).to(torch.int64) * u32_to_signed(f)) & _U32
            else:
                term = (conv[c] % ring.q) * f
            acc = term if acc is None else acc + term
        if acc is None:
            acc = torch.zeros_like(conv[0])
        planes.append(acc)
    out = torch.stack(planes, dim=-3)
    if ring.p2fast:
        out = to_i32(out)
        return out & ring._mask if ring._mask is not None else out
    return out % ring.q


def gr_matmul_ref(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Interleaved layout: (..., t, r, D) x (..., r, s, D) -> (..., t, s, D)."""
    C = gr_matmul_planar_ref(A.movedim(-1, -3), B.movedim(-1, -3), ring)
    return C.movedim(-3, -1)
