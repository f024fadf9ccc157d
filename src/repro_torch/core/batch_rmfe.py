"""Batch-EP_RMFE — the paper's general framework (Fig. 1 + Thm III.2);
counterpart of ``repro.core.batch_rmfe``.

A batch of n products {A_i B_i} over GR(p^e, d) is packed positionwise by an
(n, m)-RMFE into ONE product over the extension GR(p^e, dm), computed by an
EP code with recovery threshold R = uvw + w - 1.  psi is linear and
psi(phi(a)phi(b)) = a*b, so psi((AB)[i,l]) = (C_1[i,l], ..., C_n[i,l]).
"""
from __future__ import annotations

from math import ceil, log
from typing import Optional

import torch

from .ep_codes import EPCode, EPCosts
from .galois import Ring
from .rmfe import build_rmfe

__all__ = ["BatchEPRMFE"]


class BatchEPRMFE:
    """Coded distributed *batch* matrix multiplication via RMFE.

    Args:
      base: the data ring GR(p^e, d) (e.g. Z_{2^32}).
      n: batch size (number of simultaneous products).
      N: number of worker nodes.
      u, v, w: EP partition parameters (w=1 => Polynomial, u=v=1 => MatDot).
      device: where tables and codewords live (None: CUDA).
    """

    def __init__(self, base: Ring, n: int, N: int, u: int, v: int, w: int, device=None):
        self.base = base
        self.n = n
        # the extension must support N exceptional points: p^(D_ext) >= N
        min_m = ceil(log(max(N, 2)) / (log(base.p) * base.D))
        self.rmfe = build_rmfe(base, n, min_m=min_m, device=device)
        self.ext = self.rmfe.ext
        if self.ext.p**self.ext.D < N:
            raise ValueError(f"extension {self.ext} still has < {N} exceptional points")
        self.code = EPCode(self.ext, N, u, v, w, device=device)

    @property
    def R(self) -> int:
        return self.code.R

    def pack(self, Ms: torch.Tensor) -> torch.Tensor:
        """(n, a, b, baseD) -> packed (a, b, extD) via phi positionwise."""
        n, a, b, D = Ms.shape
        assert n == self.rmfe.n, (n, self.rmfe.n)
        return self.rmfe.phi(Ms.movedim(0, 2))  # (a, b, extD)

    def unpack(self, C: torch.Tensor) -> torch.Tensor:
        """(a, b, extD) -> (n, a, b, baseD) via psi positionwise."""
        return self.rmfe.psi(C).movedim(2, 0)

    def run(
        self, As: torch.Tensor, Bs: torch.Tensor, idx: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """As: (n, t, r, baseD), Bs: (n, r, s, baseD) -> (n, t, s, baseD)."""
        C = self.code.run(self.pack(As), self.pack(Bs), idx)
        return self.unpack(C)

    def encode(self, As, Bs):
        A, B = self.pack(As), self.pack(Bs)
        return self.code.encode_a(A), self.code.encode_b(B)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.unpack(self.code.decode(H, idx))

    def costs(self, t: int, r: int, s: int) -> EPCosts:
        """Amortized per-product costs (Thm III.2), in base-ring elements."""
        return self.code.costs(t, r, s, self.base, batch=self.n)
