"""CSA / GCSA batch codes for batch DMM over a Galois ring (paper Table 1);
counterpart of ``repro.core.gcsa``.

* :class:`CSACode` — the (u, v, w) = (1, 1, 1), kappa = n point,
  R_CSA = 2n - 1.
* :class:`GCSACode` — the general (u, v, w, kappa) construction: EP inner
  partitioning composed with the CSA outer Cauchy structure over
  kappa-grouped batches, R = uvw(n + kappa - 1) + w - 1.

The construction and the host tables (``enc_a``, ``cauchy``, ``cg_inv``,
``vand``, ``Ea``, ``Eb``, ``M``, ``Tinv``) are the reference's, built with the
same exact object-int arithmetic; the encodes are ring matmuls (the grouped
``vmap`` of the reference is one batched call).

Decode.  The reference solves the generalized Cauchy-Vandermonde system of
the live set over the whole payload (``gr_solve``: R elimination steps, each
a full-payload ring product).  Here the system's matrix depends only on the
live set, so its inverse is built exactly on the host and folded with the
read-out into ONE decode matrix per live set (LRU-cached on the code and
applied with one ring matmul):

* CSA: ``diag(cg_inv) · M_idx⁻¹[:L]``, (L, R);
* GCSA: for each product g, ``Tinv[g] · flip(M_idx⁻¹[g·uvw : (g+1)·uvw])``,
  rows ``exp_c``, stacked, (L·u·v, R).

The inverse of an invertible matrix over a commutative ring is unique and
ring matmul is associative, so the output is bit for bit the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .ep_codes import EPCosts
from .galois import Ring, from_numpy, to_numpy
from .polyops import LiveSetCache, as_u32, live_set, s_inverse, s_matmul, s_vandermonde

__all__ = ["CSACode", "GCSACode", "gcsa_cost_model", "gr_solve"]


def is_unit_mask(ring: Ring, x: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (...,) bool: element is a unit iff some coeff != 0 mod p."""
    # p = 2 storage holds uint32 bit patterns in int32: the parity of the
    # signed value is the parity of the word, and torch's % is non-negative
    return torch.any(x % ring.p != 0, dim=-1)


def gr_solve(ring: Ring, M: torch.Tensor, Y: torch.Tensor, *, check: bool = True) -> torch.Tensor:
    """Solve M X = Y over the ring; M (n, n, D) invertible, Y (n, b, D).

    Built as the exact host inverse of M (:func:`polyops.s_inverse`,
    unit-pivot Gauss-Jordan) and one ring matmul.  A singular M always
    raises ``ValueError`` eagerly, with the reference's message: the host
    inverse has no pivot to fall back on, so ``check`` (kept for the
    reference's signature, where ``check=False`` lets a traced solve return
    garbage) changes nothing here.
    """
    del check
    Minv = s_inverse(ring, to_numpy(M).astype(object))
    return ring.matmul(from_numpy(as_u32(Minv), ring, Y.device), Y)


class CSACode:
    """Batch DMM of L products over ``ring`` with N workers, R = 2L-1.
    Tables live on ``device`` (None: CUDA)."""

    def __init__(self, ring: Ring, L: int, N: int, device=None):
        self.ring = ring
        self.device = resolve_device(device)
        self.L, self.N = L, N
        self.R = 2 * L - 1
        if self.R > N:
            raise ValueError(f"R={self.R} > N={N}")
        if L + N > ring.p**ring.D:
            raise ValueError(
                f"need {L + N} exceptional points, |T| = {ring.p}^{ring.D}"
            )
        pts = ring.exceptional_points(L + N)
        fs, alphas = pts[:L], pts[L:]
        self.fs_np, self.alphas_np = fs, alphas

        # host precompute: cauchy terms, Delta(alpha), c_g
        cau = np.zeros((N, L, ring.D), dtype=object)  # 1/(f_g - a_i)
        delta = np.zeros((N, ring.D), dtype=object)
        for i in range(N):
            d = ring.s_one()
            for g in range(L):
                diff = ring.s_sub(fs[g].astype(object), alphas[i].astype(object))
                cau[i, g] = ring.s_inv(diff)
                d = ring.s_mul(d, diff)
            delta[i] = d
        cg = np.zeros((L, ring.D), dtype=object)
        for g in range(L):
            c = ring.s_one()
            for d_ in range(L):
                if d_ != g:
                    c = ring.s_mul(
                        c, ring.s_sub(fs[d_].astype(object), fs[g].astype(object))
                    )
            cg[g] = c
        enc_a = np.array(
            [[ring.s_mul(delta[i], cau[i, g]) for g in range(L)] for i in range(N)],
            dtype=object,
        )  # (N, L, D): Delta(a_i)/(f_g - a_i)
        self.cg_inv_np = np.array([ring.s_inv(cg[g]) for g in range(L)], dtype=object)
        V = s_vandermonde(ring, alphas, max(L - 1, 1))  # (N, L-1, D)
        # decode system rows: Cauchy columns, then the Vandermonde ones
        self.M_np = np.concatenate([cau, V[:, : L - 1]], axis=1)  # (N, R, D)

        dev = self.device
        self.cauchy = from_numpy(as_u32(cau), ring, dev)  # (N, L, D)
        self.enc_a = from_numpy(as_u32(enc_a), ring, dev)
        self.cg_inv = from_numpy(as_u32(self.cg_inv_np), ring, dev)  # (L, D)
        self.vand = from_numpy(as_u32(V), ring, dev)
        self.points = from_numpy(alphas, ring, dev)
        self._decode_mats = LiveSetCache(ring, dev)

    # -- encode ---------------------------------------------------------------

    def encode_a(self, As: torch.Tensor) -> torch.Tensor:
        """As (L, t, r, D) -> (N, t, r, D)."""
        L, t, r, D = As.shape
        return self.ring.matmul(self.enc_a, As.reshape(L, t * r, D)).reshape(self.N, t, r, D)

    def encode_b(self, Bs: torch.Tensor) -> torch.Tensor:
        L, r, s, D = Bs.shape
        return self.ring.matmul(self.cauchy, Bs.reshape(L, r * s, D)).reshape(self.N, r, s, D)

    def encode_a_at(self, As: torch.Tensor, i: int) -> torch.Tensor:
        """Worker i's A~_i only (encode-at-worker)."""
        L, t, r, D = As.shape
        return self.ring.matmul(self.enc_a[i : i + 1], As.reshape(L, t * r, D))[0].reshape(t, r, D)

    def encode_b_at(self, Bs: torch.Tensor, i: int) -> torch.Tensor:
        L, r, s, D = Bs.shape
        return self.ring.matmul(self.cauchy[i : i + 1], Bs.reshape(L, r * s, D))[0].reshape(
            r, s, D)

    def worker_compute(self, FA: torch.Tensor, GB: torch.Tensor) -> torch.Tensor:
        """All N block products in one batched ring matmul."""
        return self.ring.matmul(FA, GB)

    # -- decode -----------------------------------------------------------------

    def decode_matrix(self, live: Tuple[int, ...]) -> torch.Tensor:
        """(L, R, D) on the device: ``diag(cg_inv) · M_live⁻¹[:L]``, built
        exactly on the host once per live set (LRU-cached); raises
        ``ValueError`` on a singular system."""

        def build():
            Minv = s_inverse(self.ring, self.M_np[list(live)])
            return np.array([[self.ring.s_mul(self.cg_inv_np[g], Minv[g, j])
                              for j in range(self.R)] for g in range(self.L)], dtype=object)

        return self._decode_mats.get(live, build)

    def decode(self, H: torch.Tensor, idx) -> torch.Tensor:
        """H (R, t, s, D) from workers idx (R,) -> (L, t, s, D) products.

        Duplicate live-set indices and singular systems raise ``ValueError``
        host-side before anything is launched.
        """
        live = live_set(idx, self.N)  # the reference's _check_live_set
        R, t, s, D = H.shape
        assert R == self.R, (R, self.R)
        W = self.decode_matrix(live)
        return self.ring.matmul(W, H.reshape(R, t * s, D)).reshape(self.L, t, s, D)

    def run(self, As, Bs, idx: Optional[torch.Tensor] = None):
        FA, GB = self.encode_a(As), self.encode_b(Bs)
        H = self.worker_compute(FA, GB)
        if idx is None:
            idx = torch.arange(self.R, device=H.device)
        idx = torch.as_tensor(idx, device=H.device, dtype=torch.int64)
        return self.decode(H.index_select(0, idx), idx)

    def costs(self, spec) -> EPCosts:
        """Analytic costs for a ProblemSpec (the shared ``costs(spec)``
        surface; the reference's deprecated positional form is not ported)."""
        return gcsa_cost_model(
            spec.t, spec.r, spec.s, 1, 1, 1, self.L, self.L, self.N,
            self.ring.D / spec.ring.D,
        )


def _trunc_pow_prod(ring: Ring, cs, e: int, K: int):
    """First K coefficients (in x) of prod_c (c + x)^e, object arithmetic."""
    poly = [ring.s_one()] + [ring.s_zero() for _ in range(K - 1)]
    for c in cs:
        for _ in range(e):
            nxt = []
            for j in range(K):
                term = ring.s_mul(poly[j], c)
                if j:
                    term = ring.s_add(term, poly[j - 1])
                nxt.append(term)
            poly = nxt
    return poly


def _series_inv(ring: Ring, rho, K: int):
    """sigma with sigma * rho = 1 mod x^K (rho[0] must be a unit)."""
    sigma = [ring.s_inv(rho[0])]
    for j in range(1, K):
        acc = ring.s_zero()
        for i in range(1, j + 1):
            acc = ring.s_add(acc, ring.s_mul(rho[i], sigma[j - i]))
        sigma.append(ring.s_sub(ring.s_zero(), ring.s_mul(sigma[0], acc)))
    return sigma


class GCSACode:
    """General-(u, v, w, kappa) GCSA: batch DMM of L products over ``ring``
    with N workers, R = uvw(L + kappa - 1) + w - 1 (see the reference's
    module docstring for the construction).

    ``kappa`` must divide L; ``kappa = L`` with u = v = w = 1 is the
    :class:`CSACode` point (bit-identical shares and decode).  Tables live
    on ``device`` (None: CUDA).
    """

    def __init__(
        self, ring: Ring, L: int, N: int, u: int = 1, v: int = 1,
        w: int = 1, kappa: Optional[int] = None, device=None,
    ):
        kappa = L if kappa is None else kappa
        if min(u, v, w, kappa) < 1:
            raise ValueError(
                f"partition (u={u}, v={v}, w={w}, kappa={kappa}) must be >= 1"
            )
        if L % kappa:
            raise ValueError(f"kappa={kappa} must divide the batch L={L}")
        self.ring = ring
        self.device = resolve_device(device)
        self.L, self.N = L, N
        self.u, self.v, self.w, self.kappa = u, v, w, kappa
        self.nl = L // kappa  # number of kappa-groups ("ell")
        uvw = u * v * w
        self.uvw = uvw
        self.R = uvw * (L + kappa - 1) + w - 1
        if self.R > N:
            raise ValueError(f"R={self.R} > N={N}")
        if L + N > ring.p**ring.D:
            raise ValueError(
                f"need {L + N} exceptional points, |T| = {ring.p}^{ring.D}"
            )
        pts = ring.exceptional_points(L + N)
        betas, alphas = pts[:L], pts[L:]
        self.betas_np, self.alphas_np = betas, alphas

        # EP exponent layout (same zero-based layout as EPCode)
        exp_f = [i * w + j for i in range(u) for j in range(w)]
        exp_g = [(w - 1 - k) + l * u * w for k in range(w) for l in range(v)]
        self.exp_c = np.array(
            [[i * w + (w - 1) + l * u * w for l in range(v)] for i in range(u)]
        )  # (u, v): exponents carrying the useful blocks, all <= uvw - 1

        # host precompute (exact object-int arithmetic), as in the reference:
        # per-group encode coefficient tensors + the pole half of the decode
        # basis.  Column order within a group is (k, EP-block).
        Ea = np.zeros((N, self.nl, kappa * u * w, ring.D), dtype=object)
        Eb = np.zeros((N, self.nl, kappa * w * v, ring.D), dtype=object)
        pole = np.zeros((N, L * uvw, ring.D), dtype=object)
        for i in range(N):
            a_i = alphas[i].astype(object)
            for l in range(self.nl):
                xs = [
                    ring.s_sub(betas[l * kappa + k].astype(object), a_i)
                    for k in range(kappa)
                ]
                delta = ring.s_one()
                for x in xs:
                    delta = ring.s_mul(delta, x)
                dpow = ring.s_pow(delta, uvw)  # Delta_l^{uvw}
                for k in range(kappa):
                    g = l * kappa + k
                    xinv = ring.s_inv(xs[k])
                    xp = [None, xinv]  # xp[m] = (beta_g - alpha_i)^{-m}
                    for _ in range(uvw - 1):
                        xp.append(ring.s_mul(xp[-1], xinv))
                    for m in range(1, uvw + 1):
                        pole[i, g * uvw + (m - 1)] = xp[m]
                    for a, e in enumerate(exp_f):
                        Ea[i, l, k * u * w + a] = ring.s_mul(dpow, xp[uvw - e])
                    for b, e in enumerate(exp_g):
                        Eb[i, l, k * w * v + b] = xp[uvw - e]

        # decode basis: per product g the pole columns x_g^{-m} (m=1..uvw),
        # then a Vandermonde block absorbing the polynomial interference of
        # degree <= (kappa-1)uvw + w - 2 (absent when that is negative)
        polyK = (kappa - 1) * uvw + w - 1
        if polyK > 0:
            M = np.concatenate([pole, s_vandermonde(ring, alphas, polyK)], axis=1)
        else:
            M = pole
        assert M.shape[1] == self.R, (M.shape, self.R)
        self.M_np = M  # (N, R, D)

        # per-product Toeplitz recovery h = T[g] @ Gamma' (see the reference)
        T = np.zeros((L, uvw, uvw, ring.D), dtype=object)
        for g in range(L):
            l, k = divmod(g, kappa)
            cs = [
                ring.s_sub(
                    betas[l * kappa + k2].astype(object), betas[g].astype(object)
                )
                for k2 in range(kappa)
                if k2 != k
            ]
            rho = _trunc_pow_prod(ring, cs, uvw, uvw)
            sigma = _series_inv(ring, rho, uvw)
            for d in range(uvw):
                for e in range(d + 1):
                    T[g, d, e] = sigma[d - e]
        self.Tinv_np = T

        dev = self.device
        self.points = from_numpy(alphas, ring, dev)
        # (nl, N, kappa*u*w, D): group-major, so each group's encode is one
        # slice of a single batched ring matmul
        self.Ea = from_numpy(as_u32(Ea), ring, dev)  # (N, nl, kappa*u*w, D)
        self.Eb = from_numpy(as_u32(Eb), ring, dev)  # (N, nl, kappa*w*v, D)
        self._Ea_g = self.Ea.movedim(1, 0).contiguous()
        self._Eb_g = self.Eb.movedim(1, 0).contiguous()
        self.M = from_numpy(as_u32(M), ring, dev)  # (N, R, D)
        self.Tinv = from_numpy(as_u32(T), ring, dev)  # (L, uvw, uvw, D)
        self._decode_mats = LiveSetCache(ring, dev)

    # -- partitioning ---------------------------------------------------------

    def _split_a(self, As: torch.Tensor) -> torch.Tensor:
        """(L, t, r, D) -> (L, uw, t/u, r/w, D), ordered to match exp_f."""
        L, t, r, D = As.shape
        u, w = self.u, self.w
        if L != self.L or t % u or r % w:
            raise ValueError(
                f"As {tuple(As.shape)} not partitionable by (L={self.L}, u={u}, w={w})"
            )
        blocks = As.reshape(L, u, t // u, w, r // w, D)
        return blocks.permute(0, 1, 3, 2, 4, 5).reshape(L, u * w, t // u, r // w, D)

    def _split_b(self, Bs: torch.Tensor) -> torch.Tensor:
        """(L, r, s, D) -> (L, wv, r/w, s/v, D), ordered to match exp_g."""
        L, r, s, D = Bs.shape
        w, v = self.w, self.v
        if L != self.L or r % w or s % v:
            raise ValueError(
                f"Bs {tuple(Bs.shape)} not partitionable by (L={self.L}, w={w}, v={v})"
            )
        blocks = Bs.reshape(L, w, r // w, v, s // v, D)
        return blocks.permute(0, 1, 3, 2, 4, 5).reshape(L, w * v, r // w, s // v, D)

    # -- encode ---------------------------------------------------------------

    def _encode_groups(self, E: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
        """Per-group encode as ONE batched ring matmul: E (nl, n, K, D) x the
        grouped blocks (nl, K, M, D) -> (nl, n, M, D)."""
        L, K, x, y, D = blocks.shape
        grp = blocks.reshape(self.nl, self.kappa * K, x * y, D)
        if self.nl == 1:  # a single group: the unbatched call
            return self.ring.matmul(E[0], grp[0])[None]
        return self.ring.matmul(E, grp)

    def encode_a(self, As: torch.Tensor) -> torch.Tensor:
        """As (L, t, r, D) -> block-concat shares (N, t/u, nl * r/w, D)."""
        blocks = self._split_a(As)  # (L, uw, tb, rb, D)
        _, _, tb, rb, D = blocks.shape
        out = self._encode_groups(self._Ea_g, blocks).reshape(self.nl, self.N, tb, rb, D)
        return out.permute(1, 2, 0, 3, 4).reshape(self.N, tb, self.nl * rb, D)

    def encode_b(self, Bs: torch.Tensor) -> torch.Tensor:
        """Bs (L, r, s, D) -> block-concat shares (N, nl * r/w, s/v, D)."""
        blocks = self._split_b(Bs)  # (L, wv, rb, sb, D)
        _, _, rb, sb, D = blocks.shape
        out = self._encode_groups(self._Eb_g, blocks).reshape(self.nl, self.N, rb, sb, D)
        return out.permute(1, 0, 2, 3, 4).reshape(self.N, self.nl * rb, sb, D)

    def encode_a_at(self, As: torch.Tensor, i: int) -> torch.Tensor:
        """Worker i's fa_i only."""
        blocks = self._split_a(As)
        _, _, tb, rb, D = blocks.shape
        out = self._encode_groups(self._Ea_g[:, i : i + 1], blocks).reshape(self.nl, tb, rb, D)
        return out.permute(1, 0, 2, 3).reshape(tb, self.nl * rb, D)

    def encode_b_at(self, Bs: torch.Tensor, i: int) -> torch.Tensor:
        blocks = self._split_b(Bs)
        _, _, rb, sb, D = blocks.shape
        out = self._encode_groups(self._Eb_g[:, i : i + 1], blocks)
        return out.reshape(self.nl * rb, sb, D)

    # -- worker ---------------------------------------------------------------

    def worker_compute(self, FA: torch.Tensor, GB: torch.Tensor) -> torch.Tensor:
        """(N, tb, nl*rb, D) x (N, nl*rb, sb, D) -> (N, tb, sb, D), one
        batched ring matmul."""
        return self.ring.matmul(FA, GB)

    # -- decode ---------------------------------------------------------------

    def decode_matrix(self, live: Tuple[int, ...]) -> torch.Tensor:
        """(L*u*v, R, D) on the device: for each product g,
        ``Tinv[g] · flip(M_live⁻¹[g*uvw : (g+1)*uvw])`` at the rows
        ``exp_c``; built exactly on the host once per live set
        (LRU-cached).  Raises ``ValueError`` on a singular system."""
        ring, uvw = self.ring, self.uvw

        def build():
            Minv = s_inverse(ring, self.M_np[list(live)])
            rows = []
            for g in range(self.L):
                # P[g, m-1] is the coefficient of (beta_g - alpha)^{-m};
                # flipping m gives Gamma'[g, e], e = uvw - m
                gamma = Minv[g * uvw : (g + 1) * uvw][::-1]
                h = s_matmul(ring, self.Tinv_np[g], gamma)  # (uvw, R, D)
                rows.append(h[self.exp_c.ravel()])
            return np.concatenate(rows, axis=0)

        return self._decode_mats.get(live, build)

    def decode(self, H: torch.Tensor, idx) -> torch.Tensor:
        """H (R, t/u, s/v, D) from workers idx (R,) -> (L, t, s, D).

        Guarded like :meth:`CSACode.decode`: duplicate live-set indices and
        singular systems raise host-side.
        """
        live = live_set(idx, self.N)
        R, tb, sb, D = H.shape
        assert R == self.R, (R, self.R)
        W = self.decode_matrix(live)
        cb = self.ring.matmul(W, H.reshape(R, tb * sb, D))
        cb = cb.reshape(self.L, self.u, self.v, tb, sb, D)
        return cb.permute(0, 1, 3, 2, 4, 5).reshape(self.L, self.u * tb, self.v * sb, D)

    # -- end to end -----------------------------------------------------------

    def run(self, As, Bs, idx: Optional[torch.Tensor] = None):
        FA, GB = self.encode_a(As), self.encode_b(Bs)
        H = self.worker_compute(FA, GB)
        if idx is None:
            idx = torch.arange(self.R, device=H.device)
        idx = torch.as_tensor(idx, device=H.device, dtype=torch.int64)
        return self.decode(H.index_select(0, idx), idx)

    def costs(self, spec) -> EPCosts:
        return gcsa_cost_model(
            spec.t, spec.r, spec.s, self.u, self.v, self.w, self.L,
            self.kappa, self.N, self.ring.D / spec.ring.D,
        )


def gcsa_cost_model(
    t: int, r: int, s: int, u: int, v: int, w: int,
    n: int, kappa: int, N: int, m_eff: float,
) -> EPCosts:
    """Table-1 GCSA costs, per product, in base-ring elements (the
    reference's audited formulas):

      upload   N * (tb*rb + rb*sb) * m_eff / kappa
      download R * tb*sb * m_eff / n
      encode   N * (uw*tb*rb + wv*rb*sb) * m_eff^2
      decode   R^2 * tb*sb * m_eff^2 / n
      worker   tb*rb*sb * m_eff^2 / kappa

    with R = uvw(n + kappa - 1) + w - 1.  GCSA needs >= N + n exceptional
    points (vs N for Batch-EP_RMFE).
    """
    if n % kappa:
        raise ValueError(f"kappa={kappa} must divide the batch n={n}")
    R = u * v * w * (n + kappa - 1) + w - 1
    tb, rb, sb = t // u, r // w, s // v
    up = N * (tb * rb + rb * sb) * m_eff / kappa
    down = R * tb * sb * m_eff / n
    enc = N * (tb * rb * u * w + rb * sb * w * v) * m_eff**2
    dec = R * R * tb * sb * m_eff**2 / n
    worker = tb * rb * sb * m_eff**2 / kappa
    return EPCosts(N, R, m_eff, up, down, enc, dec, worker)
