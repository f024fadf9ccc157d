"""T-private (secure) CDMM over Galois rings: EP codes with random masking;
counterpart of ``repro.core.secure``.

Each encoding polynomial carries ``T`` uniformly random mask coefficients
placed above the data terms:

    f(x) = sum_ij A_ij x^{(i-1)w + (j-1)}        + sum_{k<T} Z_k x^{uvw + k}
    g(x) = sum_kl B_kl x^{(w-k) + (l-1)uw}       + sum_{k<T} W_k x^{uvw + k}

evaluated at the exceptional points 1..N (the zero point is skipped: it
would hand one worker an unmasked block).  Any T workers' shares are
uniform, independent of the data; R_secure = 2uvw + 2T - 1 responses
decode, and the read-out exponents of C all lie below the interference
terms (see the reference's module docstring for the argument).

Randomness.  The reference derives masks from a ``jax.random`` key.  Here a
key is a non-negative Python int: the A side draws from a fresh
``torch.Generator`` seeded with ``fold_in(key, 0)``, the B side with
``fold_in(key, 1)`` (``galois.fold_in``), so master-side ``encode_*`` and
at-worker ``encode_*_at`` regenerate the same masks from the same key.
The masks are not the reference's bits, CPU and CUDA draws differ, and
privacy needs a fresh key per call.  ``encode_*_with_masks`` take explicit
masks, which is how the tests hold the port to the reference.

Decode.  The live set's Lagrange coefficient matrix is built exactly on the
host, its rows ``exp_c`` cached per live set and applied with one ring
matmul (as ``EPCode.decode``).
"""
from __future__ import annotations

from math import ceil, log
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .ep_codes import EPCosts, ep_cost_model, secure_recovery_threshold, smallest_embedding_ext
from .galois import Ring, fold_in, from_numpy
from .polyops import LiveSetCache, as_u32, live_set, s_lagrange_coeff_matrix, s_vandermonde
from .rmfe import build_rmfe

__all__ = [
    "SecureEPCode",
    "SecureEP",
    "SecureBatchEPRMFE",
    "secure_recovery_threshold",
    "smallest_secure_ext",
]


def smallest_secure_ext(base: Ring, N: int) -> Ring:
    """Smallest extension of ``base`` with >= N + 1 exceptional points (the
    zero point is skipped: it is not a unit and would leak an unmasked
    share)."""
    return smallest_embedding_ext(base, N + 1)


class SecureEPCode:
    """T-private EP code over ``ring`` with N workers and partition (u, v, w).

    Requires N + 1 <= p^D exceptional points and R = 2uvw + 2T - 1 <= N.
    ``encode_a/encode_b`` take an integer ``key``; tables live on ``device``
    (None: CUDA).
    """

    def __init__(self, ring: Ring, N: int, u: int, v: int, w: int, T: int, device=None):
        if T < 1:
            raise ValueError(f"privacy requires T >= 1, got T={T}")
        self.ring = ring
        self.device = resolve_device(device)
        self.N, self.u, self.v, self.w, self.T = N, u, v, w, T
        uvw = u * v * w
        self.R = secure_recovery_threshold(u, v, w, T)
        if self.R > N:
            raise ValueError(
                f"secure recovery threshold {self.R} = 2uvw + 2T - 1 > N={N}"
            )
        if N + 1 > ring.p**ring.D:
            raise ValueError(
                f"T-private code needs N+1={N + 1} exceptional points (zero "
                f"point excluded) but |T(ring)|={ring.p}^{ring.D}; extend the ring"
            )
        # points 1..N: every one a unit, pairwise differences units
        pts = ring.exceptional_points(N + 1)[1:]
        self.points_np = pts
        self.points = from_numpy(pts, ring, self.device)
        # data exponents (0-indexed) as in EPCode, masks at uvw .. uvw+T-1
        self.exp_f = [i * w + j for i in range(u) for j in range(w)]
        self.exp_g = [(w - 1 - k) + l * u * w for k in range(w) for l in range(v)]
        self.mask_exp = [uvw + k for k in range(T)]
        self.deg_h = 2 * uvw + 2 * T - 2
        assert self.deg_h + 1 == self.R
        V = s_vandermonde(ring, pts, self.R)  # (N, R, D) object
        self.Vf = from_numpy(as_u32(V[:, self.exp_f + self.mask_exp]), ring, self.device)
        self.Vg = from_numpy(as_u32(V[:, self.exp_g + self.mask_exp]), ring, self.device)
        self.exp_c = np.array(
            [[i * w + (w - 1) + l * u * w for l in range(v)] for i in range(u)]
        )  # (u, v) — all < uvw, below every interference term
        self._decode_mats = LiveSetCache(ring, self.device)

    # -- partitioning (identical block layout to EPCode) --------------------

    def split_a(self, A: torch.Tensor) -> torch.Tensor:
        t, r, D = A.shape
        u, w = self.u, self.w
        assert t % u == 0 and r % w == 0, (A.shape, (u, w))
        blocks = A.reshape(u, t // u, w, r // w, D)
        return blocks.permute(0, 2, 1, 3, 4).reshape(u * w, t // u, r // w, D)

    def split_b(self, B: torch.Tensor) -> torch.Tensor:
        r, s, D = B.shape
        w, v = self.w, self.v
        assert r % w == 0 and s % v == 0, (B.shape, (w, v))
        blocks = B.reshape(w, r // w, v, s // v, D)
        return blocks.permute(0, 2, 1, 3, 4).reshape(w * v, r // w, s // v, D)

    # -- mask derivation (the randomness seam) --------------------------------

    def _require_key(self, key) -> int:
        if key is None:
            raise ValueError(
                "secure encode requires a key (masks must be fresh "
                "randomness); pass key=... through coded_matmul"
            )
        return key

    def masks_a(self, key: int, tb: int, rb: int) -> torch.Tensor:
        """(T, tb, rb, D) uniform mask blocks for the A-side polynomial."""
        return self.ring.random_torch(fold_in(key, 0), (self.T, tb, rb), self.device)

    def masks_b(self, key: int, rb: int, sb: int) -> torch.Tensor:
        return self.ring.random_torch(fold_in(key, 1), (self.T, rb, sb), self.device)

    # -- encode --------------------------------------------------------------

    def _encode(self, V: torch.Tensor, blocks: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        K, x, y, D = blocks.shape
        assert Z.shape == (self.T, x, y, D), (tuple(Z.shape), (self.T, x, y, D))
        coeffs = torch.cat([blocks, Z], dim=0)
        out = self.ring.matmul(V, coeffs.reshape(K + self.T, x * y, D))
        return out.reshape(V.shape[0], x, y, D)

    def encode_a_with_masks(self, A: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
        """Encode with explicit mask blocks Z (T, tb, rb, D) -> (N, tb, rb, D)."""
        return self._encode(self.Vf, self.split_a(A), Z)

    def encode_b_with_masks(self, B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        return self._encode(self.Vg, self.split_b(B), W)

    def encode_a(self, A: torch.Tensor, key: Optional[int] = None) -> torch.Tensor:
        key = self._require_key(key)
        t, r, _ = A.shape
        return self.encode_a_with_masks(A, self.masks_a(key, t // self.u, r // self.w))

    def encode_b(self, B: torch.Tensor, key: Optional[int] = None) -> torch.Tensor:
        key = self._require_key(key)
        r, s, _ = B.shape
        return self.encode_b_with_masks(B, self.masks_b(key, r // self.w, s // self.v))

    def encode_a_at(self, A: torch.Tensor, i: int, key: Optional[int] = None) -> torch.Tensor:
        """Worker i's masked share only, from the same masks as ``encode_a``."""
        key = self._require_key(key)
        t, r, _ = A.shape
        Z = self.masks_a(key, t // self.u, r // self.w)
        return self._encode(self.Vf[i : i + 1], self.split_a(A), Z)[0]

    def encode_b_at(self, B: torch.Tensor, i: int, key: Optional[int] = None) -> torch.Tensor:
        key = self._require_key(key)
        r, s, _ = B.shape
        W = self.masks_b(key, r // self.w, s // self.v)
        return self._encode(self.Vg[i : i + 1], self.split_b(B), W)[0]

    # -- worker / decode ------------------------------------------------------

    def worker_compute(self, FA: torch.Tensor, GB: torch.Tensor) -> torch.Tensor:
        """All N block products in one batched ring matmul."""
        return self.ring.matmul(FA, GB)

    def decode_matrix(self, live: Tuple[int, ...]) -> torch.Tensor:
        """(u*v, R, D) on the device: rows ``exp_c`` of the live points'
        Lagrange coefficient matrix, built exactly on the host once per
        live set (LRU-cached)."""
        return self._decode_mats.get(live, lambda: s_lagrange_coeff_matrix(
            self.ring, self.points_np[list(live)])[self.exp_c.ravel()])

    def decode(self, H: torch.Tensor, idx) -> torch.Tensor:
        """Recover C from ANY R = 2uvw + 2T - 1 responses (one ring matmul)."""
        R, tb, sb, D = H.shape
        assert R == self.R, (R, self.R)
        W = self.decode_matrix(live_set(idx, self.N))
        cblocks = self.ring.matmul(W, H.reshape(R, tb * sb, D))
        cblocks = cblocks.reshape(self.u, self.v, tb, sb, D)
        return cblocks.permute(0, 2, 1, 3, 4).reshape(self.u * tb, self.v * sb, D)

    # -- end to end -----------------------------------------------------------

    def run(self, A, B, key: int, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        FA, GB = self.encode_a(A, key), self.encode_b(B, key)
        H = self.worker_compute(FA, GB)
        if idx is None:
            idx = torch.arange(self.R, device=H.device)
        idx = torch.as_tensor(idx, device=H.device, dtype=torch.int64)
        return self.decode(H.index_select(0, idx), idx)

    def costs(self, t: int, r: int, s: int, base: Ring, batch: int = 1) -> EPCosts:
        return ep_cost_model(
            t, r, s, self.u, self.v, self.w, self.N,
            m_eff=self.ring.D / base.D, batch=batch, privacy_t=self.T,
        )


class SecureEP:
    """T-private single-product CDMM over a (possibly tiny) base ring: the
    base ring is embedded into the smallest extension with >= N + 1
    exceptional points and a :class:`SecureEPCode` runs there.  Masks are
    uniform over the extension, so embedding does not weaken privacy."""

    def __init__(self, base: Ring, N: int, u: int, v: int, w: int, T: int, device=None):
        self.base = base
        self.ext = smallest_secure_ext(base, N)
        self.code = SecureEPCode(self.ext, N, u, v, w, T, device=device)
        self.T = T

    @property
    def R(self) -> int:
        return self.code.R

    def embed(self, M: torch.Tensor) -> torch.Tensor:
        return self.ext.embed_base(M, self.base)

    def decode(self, H: torch.Tensor, idx) -> torch.Tensor:
        # products of embedded data stay in the embedded base ring
        return self.code.decode(H, idx)[..., : self.base.D]

    def run(self, A, B, key, idx=None) -> torch.Tensor:
        C = self.code.run(self.embed(A), self.embed(B), key, idx)
        return C[..., : self.base.D]

    def costs(self, t: int, r: int, s: int) -> EPCosts:
        return self.code.costs(t, r, s, self.base)


class SecureBatchEPRMFE:
    """T-private coded distributed batch matrix multiplication via RMFE: n
    products packed positionwise by an (n, m)-RMFE into one extension-ring
    product, computed by a :class:`SecureEPCode` whose extension carries
    >= N + 1 exceptional points."""

    def __init__(self, base: Ring, n: int, N: int, u: int, v: int, w: int, T: int,
                 device=None):
        self.base = base
        self.n = n
        self.T = T
        # the extension must support N + 1 exceptional points (zero skipped)
        min_m = ceil(log(max(N + 1, 2)) / (log(base.p) * base.D))
        self.rmfe = build_rmfe(base, n, min_m=min_m, device=device)
        self.ext = self.rmfe.ext
        if self.ext.p**self.ext.D < N + 1:
            raise ValueError(
                f"extension {self.ext} still has < {N + 1} exceptional points"
            )
        self.code = SecureEPCode(self.ext, N, u, v, w, T, device=device)

    @property
    def R(self) -> int:
        return self.code.R

    def pack(self, Ms: torch.Tensor) -> torch.Tensor:
        """(n, a, b, baseD) -> packed (a, b, extD) via phi positionwise."""
        n, a, b, D = Ms.shape
        assert n == self.rmfe.n, (n, self.rmfe.n)
        return self.rmfe.phi(Ms.movedim(0, 2))

    def unpack(self, C: torch.Tensor) -> torch.Tensor:
        return self.rmfe.psi(C).movedim(2, 0)

    def decode(self, H: torch.Tensor, idx) -> torch.Tensor:
        return self.unpack(self.code.decode(H, idx))

    def run(self, As, Bs, key, idx=None) -> torch.Tensor:
        C = self.code.run(self.pack(As), self.pack(Bs), key, idx)
        return self.unpack(C)

    def costs(self, t: int, r: int, s: int) -> EPCosts:
        return self.code.costs(t, r, s, self.base, batch=self.rmfe.n)
