"""Galois ring arithmetic GR(p^e, d) and extension towers, in PyTorch.

Counterpart of ``repro.core.galois``: the same tower representation, the same
setup-time tables (``CONVPOS``, ``FOLD``, ``T``) and the same host-side exact
``s_*`` mirrors, with the device ops written on torch tensors.

Storage
-------
An element of ``GR(p^e, D)`` is a trailing coefficient axis of length ``D``.

* p = 2, e <= 32 (``p2fast``): ``torch.int32`` holding the uint32 bit
  pattern.  Adds and products wrap mod 2^32 exactly as uint32 does, and
  2^e | 2^32, so one mask to e bits at the end is exact.  Reductions
  (``torch.sum`` promotes int32 to int64) are masked back to 32 bits.
* general q = p^e <= 2^12: ``torch.int64`` with explicit ``% q``.  Products
  stay below 2^24, so every contraction here fits int64 without chunking.

``to_numpy`` / ``from_numpy`` convert between this storage and the numpy
uint32 arrays the JAX package uses.

Devices
-------
Ring ops follow their input tensors.  Functions that create tensors
(``random``, ``ones``, ``from_numpy``...) take ``device=``; left at None
they use CUDA and raise when no card is present.  ``Ring.matmul`` goes
through :func:`repro_torch.kernels.gr_matmul`: the hand-written CUDA kernel
on the card, the plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as _kops
from ..kernels.ref import to_i32, u32_to_signed

__all__ = [
    "Ring",
    "make_ring",
    "find_irreducible_gfp",
    "is_irreducible_gfp",
    "fold_in",
    "to_numpy",
    "from_numpy",
]

# ---------------------------------------------------------------------------
# GF(p)[x] utilities (host-side, numpy int64 coefficient arrays, index=degree)
# ---------------------------------------------------------------------------


def _poly_trim(a: np.ndarray) -> np.ndarray:
    nz = np.nonzero(a)[0]
    if len(nz) == 0:
        return a[:1] * 0
    return a[: nz[-1] + 1]


def _poly_mulmod(a: np.ndarray, b: np.ndarray, f: np.ndarray, p: int) -> np.ndarray:
    """(a*b) mod f over GF(p); f monic."""
    prod = np.convolve(a.astype(np.int64), b.astype(np.int64)) % p
    return _poly_mod(prod, f, p)


def _poly_mod(a: np.ndarray, f: np.ndarray, p: int) -> np.ndarray:
    a = a.astype(np.int64) % p
    d = len(f) - 1
    a = a.copy()
    for k in range(len(a) - 1, d - 1, -1):
        c = a[k]
        if c:
            a[k - d : k + 1] = (a[k - d : k + 1] - c * f) % p
    out = a[:d]
    if len(out) < d:
        out = np.pad(out, (0, d - len(out)))
    return out


def _poly_powmod(a: np.ndarray, n: int, f: np.ndarray, p: int) -> np.ndarray:
    result = np.zeros(len(f) - 1, dtype=np.int64)
    result[0] = 1
    base = _poly_mod(a, f, p)
    while n:
        if n & 1:
            result = _poly_mulmod(result, base, f, p)
        base = _poly_mulmod(base, base, f, p)
        n >>= 1
    return result


def _poly_gcd(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    a, b = _poly_trim(a % p), _poly_trim(b % p)
    while len(b) > 1 or (len(b) == 1 and b[0] != 0):
        inv_lead = pow(int(b[-1]), p - 2, p)
        bm = (b * inv_lead) % p
        r = a.astype(np.int64) % p
        db = len(bm) - 1
        r = r.copy()
        for k in range(len(r) - 1, db - 1, -1):
            c = r[k]
            if c:
                r[k - db : k + 1] = (r[k - db : k + 1] - c * bm) % p
        r = _poly_trim(r[:db] if db > 0 else r[:1] * 0)
        a, b = bm, r
    return a


def _prime_factors(n: int) -> Tuple[int, ...]:
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            if not out or out[-1] != d:
                out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return tuple(out)


def is_irreducible_gfp(f: np.ndarray, p: int) -> bool:
    """Rabin irreducibility test for a monic polynomial over GF(p)."""
    n = len(f) - 1
    if n <= 0:
        return False
    x = np.array([0, 1], dtype=np.int64)
    xq = _poly_powmod(x, p**n, f, p)
    xx = _poly_mod(x, f, p)
    if not np.array_equal(xq, xx):
        return False
    for ell in _prime_factors(n):
        h = _poly_powmod(x, p ** (n // ell), f, p)
        diff = (h - xx) % p
        g = _poly_gcd(f.astype(np.int64), diff, p)
        if not (len(_poly_trim(g)) == 1 and _poly_trim(g)[0] != 0):
            return False
    return True


@lru_cache(maxsize=None)
def find_irreducible_gfp(p: int, d: int) -> Tuple[int, ...]:
    """Deterministic search for a monic degree-d irreducible over GF(p).

    Returns the coefficient tuple (len d+1, entries in 0..p-1, monic).
    """
    if d == 1:
        return (0, 1)  # x
    # low coefficients as a base-p counter; the constant term must be != 0
    for c in range(p**d):
        digits = []
        cc = c
        for _ in range(d):
            digits.append(cc % p)
            cc //= p
        if digits[0] == 0:
            continue
        f = np.array(digits + [1], dtype=np.int64)
        if is_irreducible_gfp(f, p):
            return tuple(int(v) for v in f)
    raise RuntimeError(f"no irreducible polynomial found for p={p}, d={d}")


def _power_reduction_matrix(f: Sequence[int], q: int) -> np.ndarray:
    """Rows r = 0..2d-2: coefficients of x^r mod f, over Z_q. Shape (2d-1, d)."""
    f = np.array(f, dtype=object)
    d = len(f) - 1
    rows = np.zeros((2 * d - 1, d), dtype=object)
    cur = np.zeros(d, dtype=object)
    cur[0] = 1
    rows[0] = cur
    for r in range(1, 2 * d - 1):
        nxt = np.zeros(d, dtype=object)
        nxt[1:] = cur[: d - 1]
        top = cur[d - 1]
        if top:
            # x^d = -(f[0] + f[1] x + ... + f[d-1] x^{d-1}) mod q
            for i in range(d):
                nxt[i] = (nxt[i] - top * f[i]) % q
        nxt %= q
        rows[r] = nxt
        cur = nxt
    return rows


# ---------------------------------------------------------------------------
# integer keys (the port's counterpart of jax.random keys)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One SplitMix64 output step: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _seed64(key: int) -> int:
    """A non-negative Python int key -> a 64-bit generator seed."""
    key = int(key)
    if key < 0:
        raise ValueError(f"keys are non-negative integers, got {key}")
    seed = 0
    while True:  # fold every 64-bit word of a long key
        seed = _splitmix64(seed ^ (key & _M64))
        key >>= 64
        if not key:
            return seed


def fold_in(key: int, data: int) -> int:
    """A new key from (key, data), as ``jax.random.fold_in`` derives one:
    ``splitmix64(seed64(key) ^ splitmix64(data))``.  Secure codes seed the
    A side with ``fold_in(key, 0)`` and the B side with ``fold_in(key, 1)``."""
    return _splitmix64(_seed64(key) ^ _splitmix64(int(data) & _M64))


# ---------------------------------------------------------------------------
# storage conversion
# ---------------------------------------------------------------------------


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Ring tensor (either storage) -> numpy uint32, the JAX package's layout."""
    x = x.detach().cpu()
    if x.dtype == torch.int32:
        return x.numpy().view(np.uint32)
    return x.numpy().astype(np.uint32)


def from_numpy(arr, ring: "Ring", device=None) -> torch.Tensor:
    """numpy uint32 (or any unsigned ints below q) -> ``ring``'s storage."""
    device = resolve_device(device)
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64).astype(np.uint32))
    if ring.p2fast:
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    return torch.from_numpy(a.astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# the Ring class
# ---------------------------------------------------------------------------


class Ring:
    """GR(p^e, D) with D = prod(degrees), tower representation (see module doc).

    Torch methods take and return tensors in the ring's storage dtype;
    ``s_*`` methods are host-side exact python-int mirrors used for
    setup-time constants.
    """

    def __init__(self, p: int, e: int, degrees: Tuple[int, ...]):
        degrees = tuple(int(d) for d in degrees if int(d) > 1)
        self.p = int(p)
        self.e = int(e)
        self.q = p**e
        self.degrees = degrees
        self.D = int(np.prod(degrees)) if degrees else 1
        self.p2fast = p == 2 and e <= 32
        if not self.p2fast and self.q > (1 << 12):
            raise NotImplementedError(
                f"general modulus q={self.q} > 2^12 needs wider accumulators; "
                "use p=2, e<=32 for the machine-word fast path"
            )
        self.dtype = torch.int32 if self.p2fast else torch.int64
        # e-bit mask of the p2fast path (None: e = 32, int32 wrap is exact)
        self._mask = (2**e - 1) if (p == 2 and e < 32) else None

        acc = 1
        self.moduli = []
        for m in degrees:
            if acc > 1 and math.gcd(m, acc) != 1:
                raise ValueError(
                    f"tower degree {m} not coprime with lower degrees (prod={acc}); "
                    "use Ring.extend() which auto-adjusts"
                )
            self.moduli.append(find_irreducible_gfp(p, m))
            acc *= m

        self._build_tables()
        self._dev_tables: Dict[Tuple[str, str], torch.Tensor] = {}

    # -- construction of CONVPOS / FOLD / T --------------------------------

    def _build_tables(self):
        q = self.q
        if not self.degrees:
            self.conv_shape = (1,)
            self.K = 1
            self.CONVPOS = np.zeros((1, 1), dtype=np.int32)
            self.FOLD = np.ones((1, 1), dtype=object)
        else:
            # flat layout: the innermost level (degrees[0]) varies fastest
            shapes_rev = tuple(reversed(self.degrees))  # outer ... inner
            conv_shape = tuple(2 * m - 1 for m in shapes_rev)
            K = int(np.prod(conv_shape))
            D = self.D
            idx = np.arange(D)
            multis = np.stack(np.unravel_index(idx, shapes_rev), axis=-1)  # (D, L)
            conv_pos = np.zeros((D, D), dtype=np.int64)
            for i in range(D):
                summed = multis[i][None, :] + multis  # (D, L)
                conv_pos[i] = np.ravel_multi_index(
                    tuple(summed[:, k] for k in range(summed.shape[1])), conv_shape
                )
            self.conv_shape = conv_shape
            self.K = K
            self.CONVPOS = conv_pos.astype(np.int32)
            # FOLD = kron over levels, outermost first so innermost lands inner
            fold = np.ones((1, 1), dtype=object)
            for m, modulus in zip(shapes_rev, reversed(self.moduli)):
                red = _power_reduction_matrix(modulus, q)  # (2m-1, m)
                A0, B0 = fold.shape
                C0, D0 = red.shape
                newf = np.zeros((A0 * C0, B0 * D0), dtype=object)
                for a in range(A0):
                    for b in range(B0):
                        if fold[a, b]:
                            newf[a * C0 : (a + 1) * C0, b * D0 : (b + 1) * D0] = (
                                fold[a, b] * red
                            ) % q
                fold = newf
            assert fold.shape == (K, D), (fold.shape, K, D)
            self.FOLD = fold % q

        # structure constants T[i,j,k] = FOLD[CONVPOS[i,j], k]
        D = self.D
        T = np.zeros((D, D, D), dtype=object)
        for i in range(D):
            T[i] = self.FOLD[self.CONVPOS[i]]
        self.T = T
        self.FOLD_U32 = self.FOLD.astype(np.uint64).astype(np.uint32)

    def table(self, name: str, device) -> torch.Tensor:
        """Device copy of a setup-time table, cached per device.

        ``"fold"``: FOLD (K, D) in the ring's storage; ``"convpos"``:
        CONVPOS (D, D) as int64 indices.
        """
        device = torch.device(device)
        key = (name, str(device))
        t = self._dev_tables.get(key)
        if t is None:
            if name == "fold":
                t = from_numpy(self.FOLD_U32, self, device)
            elif name == "convpos":
                t = torch.from_numpy(self.CONVPOS.astype(np.int64)).to(device)
            else:
                raise KeyError(name)
            self._dev_tables[key] = t
        return t

    # -- basics -------------------------------------------------------------

    def __repr__(self):
        return f"GR({self.p}^{self.e}, {self.D}) degrees={self.degrees}"

    def __eq__(self, other):
        return isinstance(other, Ring) and (self.p, self.e, self.degrees) == (
            other.p, other.e, other.degrees
        )

    def __hash__(self):
        return hash((self.p, self.e, self.degrees))

    def extend(self, m: int) -> "Ring":
        """Extension of degree >= m with the coprimality constraint auto-fixed."""
        if m <= 1:
            return self
        mm = m
        while math.gcd(mm, self.D) != 1:
            mm += 1
        return make_ring(self.p, self.e, self.degrees + (mm,))

    def base_ring(self) -> "Ring":
        if not self.degrees:
            return self
        return make_ring(self.p, self.e, self.degrees[:-1])

    # -- host-side exact scalar ops (python ints) ---------------------------

    def s_zero(self) -> np.ndarray:
        return np.zeros(self.D, dtype=object)

    def s_one(self) -> np.ndarray:
        z = self.s_zero()
        z[0] = 1
        return z

    def s_from_int(self, v: int) -> np.ndarray:
        z = self.s_zero()
        z[0] = v % self.q
        return z

    def s_add(self, a, b) -> np.ndarray:
        return (np.asarray(a, dtype=object) + np.asarray(b, dtype=object)) % self.q

    def s_sub(self, a, b) -> np.ndarray:
        return (np.asarray(a, dtype=object) - np.asarray(b, dtype=object)) % self.q

    def s_mul(self, a, b) -> np.ndarray:
        a = np.asarray(a, dtype=object)
        b = np.asarray(b, dtype=object)
        conv = np.zeros(self.K, dtype=object)
        for i in range(self.D):
            ai = a[i]
            if ai:
                pos = self.CONVPOS[i]
                for j in range(self.D):
                    bj = b[j]
                    if bj:
                        conv[pos[j]] += ai * bj
        out = np.zeros(self.D, dtype=object)
        for c in range(self.K):
            v = conv[c]
            if v:
                out = out + v * self.FOLD[c]
        return out % self.q

    def s_pow(self, a, n: int) -> np.ndarray:
        result = self.s_one()
        base = np.asarray(a, dtype=object) % self.q
        while n:
            if n & 1:
                result = self.s_mul(result, base)
            base = self.s_mul(base, base)
            n >>= 1
        return result

    def s_is_unit(self, a) -> bool:
        return any(int(v) % self.p for v in np.asarray(a).ravel())

    def s_inv(self, a) -> np.ndarray:
        """Inverse of a unit: Fermat inverse mod p + Hensel lifting."""
        if not self.s_is_unit(a):
            raise ZeroDivisionError("not a unit in " + repr(self))
        x = self.s_pow(a, self.p**self.D - 2)
        two = self.s_from_int(2)
        k = 1
        while k < self.e:
            ax = self.s_mul(a, x)
            x = self.s_mul(x, self.s_sub(two, ax))
            k *= 2
        return x % self.q

    # -- exceptional set -----------------------------------------------------

    def exceptional_points(self, count: int) -> np.ndarray:
        """First ``count`` digit-lift points; pairwise differences are units.

        Returns uint32 array (count, D).
        """
        if count > self.p**self.D:
            raise ValueError(
                f"need {count} exceptional points but |T| = {self.p}^{self.D}"
            )
        pts = np.zeros((count, self.D), dtype=np.uint32)
        for i in range(count):
            c = i
            for k in range(self.D):
                pts[i, k] = c % self.p
                c //= self.p
        return pts

    # -- device-side helpers --------------------------------------------------

    def _modq(self, x: torch.Tensor) -> torch.Tensor:
        if self.p2fast:
            return x & self._mask if self._mask is not None else x
        return x % self.q

    def reduce_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Ring sum along ``dim`` (torch.sum of int32 returns int64)."""
        s = x.sum(dim=dim)
        if self.p2fast:
            return self._modq(to_i32(s))
        return s % self.q

    # -- elementwise ops -------------------------------------------------------

    def zeros(self, shape: Tuple[int, ...], device=None) -> torch.Tensor:
        device = resolve_device(device)
        return torch.zeros(tuple(shape) + (self.D,), dtype=self.dtype, device=device)

    def ones(self, shape: Tuple[int, ...], device=None) -> torch.Tensor:
        z = self.zeros(shape, device)
        z[..., 0] = 1
        return z

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._modq(a + b)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.p2fast:
            return self._modq(a - b)  # wraps correctly mod 2^e
        return (a + self.q - b) % self.q

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        if self.p2fast:
            return self._modq(-a)
        return (self.q - a) % self.q

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise ring product; a, b broadcastable with trailing dim D."""
        a, b = torch.broadcast_tensors(a, b)
        batch = a.shape[:-1]
        D, K = self.D, self.K
        conv = torch.zeros(batch + (K,), dtype=self.dtype, device=a.device)
        convpos = self.table("convpos", a.device)
        for i in range(D):
            contrib = a[..., i : i + 1] * b  # (..., D)
            if not self.p2fast:
                contrib = contrib % self.q
            # CONVPOS[i] holds D distinct positions, so += scatters exactly
            conv[..., convpos[i]] += contrib
        conv = self._modq(conv)
        # fold: out[..., d] = sum_c conv[..., c] * FOLD[c, d]; CUDA has no
        # integer matmul, so broadcast-multiply and sum over K
        fold = self.table("fold", a.device)
        return self.reduce_sum(conv[..., :, None] * fold, dim=-2)

    def matmul(self, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """Ring matmul: (t, r, D) x (r, s, D) -> (t, s, D).

        A leading batch axis on both operands, (b, t, r, D) x (b, r, s, D),
        runs b independent products in one kernel launch.
        """
        return _kops.gr_matmul(A, B, self)

    def pow(self, a: torch.Tensor, n: int) -> torch.Tensor:
        """Elementwise a**n for a python-int exponent (square and multiply)."""
        result = self.ones(a.shape[:-1], a.device)
        base = a
        while n:
            if n & 1:
                result = self.mul(result, base)
            base = self.mul(base, base) if n > 1 else base
            n >>= 1
        return result

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverse of units (Fermat mod p + Hensel lifting)."""
        x = self.pow(a, self.p**self.D - 2)
        two = self.scale(self.ones(a.shape[:-1], a.device), 2)
        k = 1
        while k < self.e:
            ax = self.mul(a, x)
            x = self.mul(x, self.sub(two, ax))
            k *= 2
        return x

    def scale(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """Multiply by an integer scalar."""
        c = c % self.q
        if self.p2fast:
            c = u32_to_signed(c)
        return self._modq(a * c)

    def random(
        self, rng: np.random.Generator, shape: Tuple[int, ...], device=None
    ) -> torch.Tensor:
        """Uniform elements drawn from ``rng`` exactly as ``repro``'s
        ``Ring.random`` draws them: the same seed gives the same elements."""
        arr = rng.integers(0, self.q, size=tuple(shape) + (self.D,), dtype=np.uint64)
        return from_numpy(arr.astype(np.uint32), self, device)

    def random_torch(self, key: int, shape: Tuple[int, ...], device=None) -> torch.Tensor:
        """Uniform elements drawn on ``device`` from a fresh ``torch.Generator``
        seeded with the integer ``key`` (counterpart of ``Ring.random_jax``).

        The same key gives the same elements on one device type; CPU and
        CUDA streams differ, and neither reproduces ``jax.random``'s bits.
        Words are drawn as int64 in [0, 2^32) and wrapped to the int32 bit
        pattern (no out-of-range cast), then masked to e bits; general-q
        rings draw in [0, q).
        """
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed64(key))
        full = tuple(shape) + (self.D,)
        if self.p2fast:
            # q = 2^e divides 2^32: masking uniform 32-bit words stays uniform
            words = torch.randint(0, 1 << 32, full, dtype=torch.int64, generator=gen,
                                  device=device)
            return self._modq(to_i32(words))
        return torch.randint(0, self.q, full, dtype=torch.int64, generator=gen, device=device)

    def random_units(
        self, rng: np.random.Generator, shape: Tuple[int, ...], device=None
    ) -> torch.Tensor:
        arr = rng.integers(0, self.q, size=tuple(shape) + (self.D,), dtype=np.uint64)
        arr = arr.astype(np.uint32)
        # a unit constant coefficient in Z_q makes the element a unit
        c0 = arr[..., 0]
        c0 = c0 - (c0 % self.p) + 1
        arr[..., 0] = c0
        return from_numpy(arr, self, device)

    # -- embeddings between tower and base ------------------------------------

    def embed_base(self, a: torch.Tensor, base: "Ring") -> torch.Tensor:
        """Embed elements of the base ring (trailing dim base.D) into self.

        self must be a tower over ``base`` (degrees prefix match); the image
        occupies the low coefficients.
        """
        assert self.degrees[: len(base.degrees)] == base.degrees
        out = torch.zeros(a.shape[:-1] + (self.D,), dtype=self.dtype, device=a.device)
        out[..., : base.D] = a
        return out

    def tower_coeffs(self, a: torch.Tensor, base: "Ring") -> torch.Tensor:
        """View (..., D) as (..., D//base.D, base.D): coefficients over the base."""
        assert self.degrees[: len(base.degrees)] == base.degrees
        t = self.D // base.D
        return a.reshape(a.shape[:-1] + (t, base.D))

    def from_tower_coeffs(self, c: torch.Tensor) -> torch.Tensor:
        return c.reshape(c.shape[:-2] + (self.D,))


@lru_cache(maxsize=None)
def make_ring(p: int, e: int, degrees: Tuple[int, ...] = ()) -> Ring:
    return Ring(p, e, degrees)
