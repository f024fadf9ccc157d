"""Bit-exact straggler-tolerant int8 matmul for serving, via CDMM over
Z_{2^32} — counterpart of ``repro.cdmm.quantized``.

Quantized inference matmuls are integer matmuls: with per-token activation
scales and per-channel weight scales,

    y = (sx ⊗ sw) * (q_x @ q_w),   q ∈ int8

and |sum_d q_x q_w| <= d * 127^2 < 2^31 for d <= 131071, so the int32
product is exact and equals its value mod 2^32.  Lifting int8
two's-complement into Z_{2^32} (with the port's int32-as-uint32 storage the
lift is ``q.to(torch.int32)[..., None]``) makes the accumulation a
Galois-ring matmul — EP_RMFE-coded across N workers, any R of which
reconstruct the EXACT integer result, so the dequantized output is
bit-identical under any allowed set of dead workers.

The coded matmul is the registered ``ep_rmfe1`` scheme executed by the
``local`` backend, or, with ``axis_name``, by ``shard_worker_body`` on each
rank of the group bound to that axis (``runtime.cdmm_shard_map``); on the
card its worker products run on the ``tc`` route and its packs, encodes and
decode on ``skinny``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.galois import make_ring
from .api import EPRMFE1Adapter
from .backends import LocalSimBackend, check_use_kernel, shard_worker_body

__all__ = ["quantize_int8", "CodedQuantMatmul", "lift_i8_to_ring", "unlift_to_i32"]


def quantize_int8(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``; returns (q, scale).

    float32 throughout; ``torch.round`` rounds half to even, as ``jnp.round``
    does, so q and the scales equal the reference's bit for bit.  The divisor
    127 is a 0-dim tensor on ``x``'s device: divided by a Python number, a
    CUDA tensor is multiplied by the float32 reciprocal instead, which puts
    the last bit of some scales off the true quotient."""
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), torch.ones_like(amax))
    q = torch.clip(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def lift_i8_to_ring(q: torch.Tensor) -> torch.Tensor:
    """int8 -> Z_{2^32} two's-complement lift, trailing ring dim D=1."""
    return q.to(torch.int32)[..., None]


def unlift_to_i32(c: torch.Tensor) -> torch.Tensor:
    """Z_{2^32} (..., 1) -> exact signed int32 result."""
    return c[..., 0]


class CodedQuantMatmul:
    """EP_RMFE-I-coded exact int8 matmul across N workers.

    n = 2 (MatDot-style split of the contraction dim) with N workers;
    u x v output partition, w | d/(2).  With N=16 the scheme runs over
    GR(2^32, 4) — the paper's 16-worker evaluation point.  The scheme's
    tables live on ``device`` (None: CUDA).

    ``axis_name``: None runs the local backend; a name makes
    :meth:`exact_int_matmul` the per-rank body over that axis (call it
    through ``runtime.cdmm_shard_map`` with the operands and mask
    replicated).  ``use_kernel`` follows the elastic backend's: None or
    True on the card, where False raises; ignored on the CPU.
    """

    def __init__(
        self,
        N: int,
        axis_name: Optional[str],
        *,
        n: int = 2,
        u: int = 2,
        v: int = 2,
        w: int = 1,
        use_kernel: Optional[bool] = None,
        device=None,
    ):
        self.base = make_ring(2, 32, ())
        self.n = n
        self.scheme = EPRMFE1Adapter(self.base, n, N, u, v, w, device=device)
        self.device = self.scheme.code.device
        check_use_kernel(self.scheme, use_kernel)
        self.axis = axis_name
        self.use_kernel = use_kernel
        self._local = LocalSimBackend()

    @property
    def R(self) -> int:
        return self.scheme.R

    def _on_device(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            raise ValueError(f"operand on {x.device}, scheme on {self.device}")
        return x

    def exact_int_matmul(
        self, qx: torch.Tensor, qw: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(tokens, d) int8 @ (d, f) int8 -> exact int32, coded across workers.

        With ``axis_name`` this runs on every rank of the group bound to
        that axis, with qx, qw and mask replicated; otherwise locally."""
        A = lift_i8_to_ring(self._on_device(qx))  # (t, d, 1)
        B = lift_i8_to_ring(self._on_device(qw))  # (d, f, 1)
        if self.axis is not None:
            C = shard_worker_body(self.scheme, self.axis, A, B, mask, use_kernel=self.use_kernel)
        else:
            C = self._local(self.scheme, A, B, mask)
        return unlift_to_i32(C)

    def __call__(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Float-in/float-out coded matmul: quantize, code, dequantize."""
        qx, sx = quantize_int8(self._on_device(x), axis=-1)  # (t, d), (t, 1)
        qw, sw = quantize_int8(self._on_device(w), axis=0)  # (d, f), (1, f)
        acc = self.exact_int_matmul(qx, qw, mask)
        return acc.to(torch.float32) * sx * sw
