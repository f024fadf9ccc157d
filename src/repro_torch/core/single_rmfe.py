"""Single-DMM optimizations via RMFE batching — EP_RMFE-I and EP_RMFE-II
(paper §IV, Corollaries IV.1 / IV.2); counterpart of
``repro.core.single_rmfe``.

Type I  (MatDot-style): A -> n column blocks, B -> n row blocks,
AB = sum_i A_i B_i through Batch-EP_RMFE on the n block products.

Type II (Polynomial-style): A -> n row blocks, B -> n column blocks; two
RMFE levels carry all n^2 products A_i B_j in ONE top-ring product.
``split_a=False`` is the paper's measured §V configuration: only B is
column-split and packed through phi_1, A is embedded.
"""
from __future__ import annotations

from math import ceil, log
from typing import Optional

import torch

from .batch_rmfe import BatchEPRMFE
from .ep_codes import EPCode, EPCosts
from .galois import Ring
from .rmfe import BasicRMFE

__all__ = ["EPRMFE_I", "EPRMFE_II"]


class EPRMFE_I:
    """Single DMM, MatDot-style batch preprocessing (Cor IV.1)."""

    def __init__(self, base: Ring, n: int, N: int, u: int, v: int, w: int, device=None):
        self.base, self.n = base, n
        self.batch = BatchEPRMFE(base, n, N, u, v, w, device=device)
        self.ext = self.batch.ext
        self.code = self.batch.code

    @property
    def R(self) -> int:
        return self.batch.R

    def split_a(self, A: torch.Tensor) -> torch.Tensor:
        """(t, r, D) -> n column blocks (n, t, r/n, D)."""
        t, r, D = A.shape
        assert r % self.n == 0, f"n={self.n} must divide r={r}"
        return A.reshape(t, self.n, r // self.n, D).movedim(1, 0)

    def split_b(self, B: torch.Tensor) -> torch.Tensor:
        """(r, s, D) -> n row blocks (n, r/n, s, D)."""
        r, s, D = B.shape
        assert r % self.n == 0, f"n={self.n} must divide r={r}"
        return B.reshape(self.n, r // self.n, s, D)

    def split(self, A: torch.Tensor, B: torch.Tensor):
        return self.split_a(A), self.split_b(B)

    def run(self, A, B, idx: Optional[torch.Tensor] = None):
        Cs = self.batch.run(*self.split(A, B), idx)  # (n, t, s, D)
        acc = Cs[0]
        for i in range(1, self.n):
            acc = self.base.add(acc, Cs[i])
        return acc

    def costs(self, t: int, r: int, s: int) -> EPCosts:
        # one EP run on (t, r/n, s) computes the ONE output product
        return self.batch.code.costs(t, r // self.n, s, self.base, batch=1)


class EPRMFE_II:
    """Single DMM, Polynomial-style batch preprocessing, two-level RMFE
    (Cor IV.2)."""

    def __init__(
        self, base: Ring, n: int, N: int, u: int, v: int, w: int,
        split_a: bool = True, device=None,
    ):
        self.base, self.n = base, n
        self.split_a = split_a
        # level 1 over the base, level 2 over the mid ring
        min_m1 = ceil(log(max(N, 2)) / (log(base.p) * base.D)) if not split_a else 0
        self.rmfe1 = BasicRMFE(base, n, min_m=min_m1, device=device)
        self.mid = self.rmfe1.ext
        if split_a:
            min_m2 = ceil(log(max(N, 2)) / (log(base.p) * self.mid.D))
            self.rmfe2 = BasicRMFE(self.mid, n, min_m=min_m2, device=device)
            self.top = self.rmfe2.ext
        else:
            self.rmfe2 = None
            self.top = self.mid
        if self.top.p**self.top.D < N:
            raise ValueError("top extension too small for N workers")
        self.code = EPCode(self.top, N, u, v, w, device=device)

    @property
    def R(self) -> int:
        return self.code.R

    def pack_a(self, A: torch.Tensor) -> torch.Tensor:
        """A (t, r, baseD) -> (t/n, r, topD): row blocks through phi2∘embed.

        With split_a=False: A is embedded whole (paper §V configuration)."""
        t, r, D = A.shape
        n = self.n
        if not self.split_a:
            return self.top.embed_base(A, self.base)  # (t, r, topD)
        assert t % n == 0
        blocks = A.reshape(n, t // n, r, D)
        mid_blocks = self.mid.embed_base(blocks, self.base)  # phi1(const) = embed
        return self.rmfe2.phi(mid_blocks.movedim(0, 2))  # (t/n, r, topD)

    def pack_b(self, B: torch.Tensor) -> torch.Tensor:
        """B (r, s, baseD) -> (r, s/n, topD): col blocks through embed∘phi1."""
        r, s, D = B.shape
        n = self.n
        assert s % n == 0
        vecs = B.reshape(r, n, s // n, D).movedim(1, 2)  # (r, s/n, n, baseD)
        mid = self.rmfe1.phi(vecs)  # (r, s/n, midD)
        return self.top.embed_base(mid, self.mid)

    def unpack(self, C: torch.Tensor) -> torch.Tensor:
        """(t/n, s/n, topD) -> (t, s, baseD) assembling the n x n block grid."""
        tb, sb, _ = C.shape
        n = self.n
        if not self.split_a:
            outs = self.rmfe1.psi(C)  # (t, s/n, n_j, baseD)
            return outs.permute(0, 2, 1, 3).reshape(tb, n * sb, self.base.D)
        mids = self.rmfe2.psi(C)  # (t/n, s/n, n_i, midD)
        outs = self.rmfe1.psi(mids)  # (t/n, s/n, n_i, n_j, baseD)
        # C block (i, j) = A_i B_j at row block i, col block j
        grid = outs.permute(2, 0, 3, 1, 4)  # (n_i, t/n, n_j, s/n, D)
        return grid.reshape(n * tb, n * sb, self.base.D)

    def run(self, A, B, idx: Optional[torch.Tensor] = None):
        C = self.code.run(self.pack_a(A), self.pack_b(B), idx)
        return self.unpack(C)

    def costs(self, t: int, r: int, s: int) -> EPCosts:
        ta = t // self.n if self.split_a else t
        return self.code.costs(ta, r, s // self.n, self.base, batch=1)
