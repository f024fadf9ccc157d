"""Entangled Polynomial codes over a Galois ring, plus the plain-embedding
CDMM baseline of Lemma III.1 — counterpart of ``repro.core.ep_codes``.

EP code, paper §III-B layout:

    A (t x r) -> u x w blocks A_ij;   f(x) = sum A_ij x^{(i-1)w + (j-1)}
    B (r x s) -> w x v blocks B_kl;   g(x) = sum B_kl x^{(w-k) + (l-1)uw}
    h = f*g has degree uvw + w - 2;   R = uvw + w - 1
    C_il = coeff of x^{(i-1)w + (w-1) + (l-1)uw} in h.

Encoding is a ring matmul against a fixed Vandermonde slice; the N worker
products are one batched ring matmul (one kernel launch on the card);
decoding interpolates h from ANY R responses: the rows ``exp_c`` of the live
set's Lagrange coefficient matrix are built exactly on the host, cached per
live set, and applied with one ring matmul.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .galois import Ring, from_numpy
from .polyops import LiveSetCache, as_u32, live_set, s_lagrange_coeff_matrix, s_vandermonde

__all__ = [
    "EPCode",
    "EPCosts",
    "PlainCDMM",
    "ep_cost_model",
    "secure_recovery_threshold",
    "smallest_embedding_ext",
]


def smallest_embedding_ext(base: Ring, npoints: int) -> Ring:
    """Smallest extension of ``base`` with >= npoints exceptional points
    (the coprimality bump in Ring.extend may make the first guess short).

    Keep in lockstep with ``repro_torch.cdmm.api._embed_ext_D``.
    """
    m = 1
    while base.p ** (base.D * m) < npoints:
        m += 1
    ext = base.extend(m) if m > 1 else base
    while ext.p**ext.D < npoints:
        m += 1
        ext = base.extend(m)
    return ext


@dataclass(frozen=True)
class EPCosts:
    """Analytic cost model, counted in elements/ops of a reference base ring
    (the paper counts everything in GR(p^e, d)).

    ``privacy_t`` is the collusion tolerance the configuration provides
    (0 = no privacy — every non-secure scheme family).
    """

    N: int
    R: int
    m_eff: float  # extension factor over the reference base ring
    upload: float
    download: float
    encode_ops: float
    decode_ops: float
    worker_ops: float
    privacy_t: int = 0


def secure_recovery_threshold(u: int, v: int, w: int, T: int) -> int:
    """R of the T-private EP code: mask degrees sit at uvw..uvw+T-1 on both
    operands, so deg h = 2uvw + 2T - 2."""
    return 2 * u * v * w + 2 * T - 1


def ep_cost_model(
    t: int, r: int, s: int, u: int, v: int, w: int, N: int, m_eff: float,
    batch: int = 1, privacy_t: int = 0,
) -> EPCosts:
    """Costs of one EP execution over an extension with [ext:base] = m_eff,
    amortized over ``batch`` products (paper Thm III.2 accounting).

    ``privacy_t > 0`` is the T-private variant: R = 2uvw + 2T - 1 and T
    extra mask coefficients per operand in the encode.
    """
    T = privacy_t
    R = secure_recovery_threshold(u, v, w, T) if T else u * v * w + w - 1
    tb, rb, sb = t // u, r // w, s // v
    up = N * (tb * rb + rb * sb) * m_eff / batch
    down = R * tb * sb * m_eff / batch
    enc = N * (tb * rb * (u * w + T) + rb * sb * (w * v + T)) * m_eff**2 / batch
    dec = R * R * tb * sb * m_eff**2 / batch
    worker = tb * rb * sb * m_eff**2 / batch
    return EPCosts(N, R, m_eff, up, down, enc, dec, worker, T)


class EPCode:
    """EP code over ``ring`` with N workers and partition (u, v, w).

    Polynomial codes: w = 1.  MatDot codes: u = v = 1.  The encode tables
    and evaluation points live on ``device`` (None: CUDA).
    """

    def __init__(self, ring: Ring, N: int, u: int, v: int, w: int, device=None):
        self.ring = ring
        self.device = resolve_device(device)
        self.N, self.u, self.v, self.w = N, u, v, w
        self.R = u * v * w + w - 1
        if self.R > N:
            raise ValueError(f"recovery threshold {self.R} > N={N}")
        if N > ring.p**ring.D:
            raise ValueError(
                f"N={N} workers need {N} exceptional points but |T|="
                f"{ring.p}^{ring.D}; extend the ring"
            )
        pts = ring.exceptional_points(N)
        self.points_np = pts
        self.points = from_numpy(pts, ring, self.device)
        # exponents (0-indexed i<u, j<w, k<w, l<v)
        self.exp_f = [i * w + j for i in range(u) for j in range(w)]
        self.exp_g = [(w - 1 - k) + l * u * w for k in range(w) for l in range(v)]
        self.deg_h = (u * w - 1) + ((w - 1) + (v - 1) * u * w)
        assert self.deg_h + 1 == self.R
        V = s_vandermonde(ring, pts, self.R)  # (N, R, D) object
        self.Vf = from_numpy(as_u32(V[:, self.exp_f]), ring, self.device)  # (N, uw, D)
        self.Vg = from_numpy(as_u32(V[:, self.exp_g]), ring, self.device)  # (N, wv, D)
        self.exp_c = np.array(
            [[i * w + (w - 1) + l * u * w for l in range(v)] for i in range(u)]
        )  # (u, v)
        self._decode_mats = LiveSetCache(ring, self.device)

    # -- partitioning ------------------------------------------------------

    def split_a(self, A: torch.Tensor) -> torch.Tensor:
        """(t, r, D) -> (uw, t/u, r/w, D), ordered to match exp_f."""
        t, r, D = A.shape
        u, w = self.u, self.w
        assert t % u == 0 and r % w == 0, (A.shape, (u, w))
        blocks = A.reshape(u, t // u, w, r // w, D)
        return blocks.permute(0, 2, 1, 3, 4).reshape(u * w, t // u, r // w, D)

    def split_b(self, B: torch.Tensor) -> torch.Tensor:
        """(r, s, D) -> (wv, r/w, s/v, D), ordered to match exp_g."""
        r, s, D = B.shape
        w, v = self.w, self.v
        assert r % w == 0 and s % v == 0, (B.shape, (w, v))
        blocks = B.reshape(w, r // w, v, s // v, D)
        return blocks.permute(0, 2, 1, 3, 4).reshape(w * v, r // w, s // v, D)

    # -- encode ------------------------------------------------------------

    def encode_a(self, A: torch.Tensor) -> torch.Tensor:
        """master-side encode: (t, r, D) -> per-worker (N, t/u, r/w, D)."""
        blocks = self.split_a(A)
        K, tb, rb, D = blocks.shape
        out = self.ring.matmul(self.Vf, blocks.reshape(K, tb * rb, D))
        return out.reshape(self.N, tb, rb, D)

    def encode_b(self, B: torch.Tensor) -> torch.Tensor:
        blocks = self.split_b(B)
        K, rb, sb, D = blocks.shape
        out = self.ring.matmul(self.Vg, blocks.reshape(K, rb * sb, D))
        return out.reshape(self.N, rb, sb, D)

    def encode_a_at(self, A: torch.Tensor, i: int) -> torch.Tensor:
        """Worker i's share f(alpha_i) only: (t, r, D) -> (tb, rb, D)."""
        blocks = self.split_a(A)
        K, tb, rb, D = blocks.shape
        out = self.ring.matmul(self.Vf[i : i + 1], blocks.reshape(K, tb * rb, D))[0]
        return out.reshape(tb, rb, D)

    def encode_b_at(self, B: torch.Tensor, i: int) -> torch.Tensor:
        blocks = self.split_b(B)
        K, rb, sb, D = blocks.shape
        out = self.ring.matmul(self.Vg[i : i + 1], blocks.reshape(K, rb * sb, D))[0]
        return out.reshape(rb, sb, D)

    # -- worker --------------------------------------------------------------

    def worker_compute(self, FA: torch.Tensor, GB: torch.Tensor) -> torch.Tensor:
        """(N, tb, rb, D) x (N, rb, sb, D) -> (N, tb, sb, D): one batched
        ring matmul (grid z = worker on the card)."""
        return self.ring.matmul(FA, GB)

    # -- decode ----------------------------------------------------------------

    def decode_matrix(self, live: Tuple[int, ...]) -> torch.Tensor:
        """(u*v, R, D) on the device: the rows ``exp_c`` of the Lagrange
        coefficient matrix of the live workers' points, built exactly on the
        host once per live set (LRU-cached)."""
        return self._decode_mats.get(live, lambda: s_lagrange_coeff_matrix(
            self.ring, self.points_np[list(live)])[self.exp_c.ravel()])

    def decode(self, H: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Recover C from responses of workers ``idx`` (any R of them).

        H: (R, tb, sb, D) responses; idx: (R,) worker ids (read on the host).
        One ring matmul: the coefficients of h read out at ``exp_c``.
        """
        R, tb, sb, D = H.shape
        assert R == self.R, (R, self.R)
        W = self.decode_matrix(live_set(idx, self.N))
        cblocks = self.ring.matmul(W, H.reshape(R, tb * sb, D))
        cblocks = cblocks.reshape(self.u, self.v, tb, sb, D)
        return cblocks.permute(0, 2, 1, 3, 4).reshape(self.u * tb, self.v * sb, D)

    # -- end to end -------------------------------------------------------------

    def run(
        self, A: torch.Tensor, B: torch.Tensor, idx: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Full pipeline with an optional worker subset (defaults to first R)."""
        FA, GB = self.encode_a(A), self.encode_b(B)
        H = self.worker_compute(FA, GB)
        if idx is None:
            idx = torch.arange(self.R, device=H.device)
        idx = idx.to(H.device, torch.int64)
        return self.decode(H.index_select(0, idx), idx)

    def costs(self, t: int, r: int, s: int, base: Ring, batch: int = 1) -> EPCosts:
        return ep_cost_model(
            t, r, s, self.u, self.v, self.w, self.N,
            m_eff=self.ring.D / base.D, batch=batch,
        )


class PlainCDMM:
    """Baseline of Lemma III.1: matrices over a small base ring are
    *embedded* into the degree-m extension (no RMFE packing) and EP codes run
    there."""

    def __init__(self, base: Ring, N: int, u: int, v: int, w: int, device=None):
        self.base = base
        self.ext = smallest_embedding_ext(base, N)
        self.code = EPCode(self.ext, N, u, v, w, device=device)

    @property
    def R(self) -> int:
        return self.code.R

    def run(
        self, A: torch.Tensor, B: torch.Tensor, idx: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """A: (t, r, baseD), B: (r, s, baseD) -> C = AB over the base ring."""
        eA = self.ext.embed_base(A, self.base)
        eB = self.ext.embed_base(B, self.base)
        C = self.code.run(eA, eB, idx)
        # products of embedded elements stay in the embedded base ring
        return C[..., : self.base.D]

    def costs(self, t: int, r: int, s: int) -> EPCosts:
        return self.code.costs(t, r, s, self.base)
