"""Unified CDMM scheme API: one protocol, one registry — counterpart of
``repro.cdmm.api`` for all nine families: ``ep``, ``plain``, ``ep_rmfe1``,
``ep_rmfe2``, ``batch_ep_rmfe``, the GCSA batch codes ``gcsa`` and
``gcsa_general``, and the T-private ``ep_secure`` and ``ep_rmfe_secure``.

Every adapter exposes the same master/worker surface:

    encode_a(A, key=None) -> (N, ...)   per-worker A shares (master-side)
    encode_b(B, key=None) -> (N, ...)   per-worker B shares
    encode_a_at(A, i, key=None)         worker i's share only
    encode_b_at(B, i, key=None)
    worker_compute(FA, GB)              all N block products (one batched launch)
    decode(H, idx)                      recover C from ANY R responses
    costs(spec) -> EPCosts              the analytic Table-1 cost model

``key`` is the masked-randomness seam: secure schemes (``privacy_t > 0``)
derive their masks from it, a non-negative int, and raise without it; the
other schemes accept and ignore it.

Shapes: ``batch == 1`` schemes take ``A (t, r, D0), B (r, s, D0)``; batch
schemes take ``As (n, t, r, D0), Bs (n, r, s, D0)``.  ``scheme.ring`` is the
codeword ring workers compute in, ``scheme.base`` the data ring.  Adapters
keep their tables on ``device`` (None: CUDA).

Families register with an analytic ``predict`` (the planner ranks with it
without building anything) and a ``build``.  A spec with ``privacy_t > 0``
is served only by the secure families.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, replace
from math import ceil, gcd, log
from typing import (
    Callable,
    Dict,
    Iterable,
    Optional,
    Protocol,
    Tuple,
    runtime_checkable,
)

import torch

from ..core.batch_rmfe import BatchEPRMFE
from ..core.ep_codes import (
    EPCode,
    EPCosts,
    PlainCDMM,
    ep_cost_model,
    secure_recovery_threshold,
    smallest_embedding_ext,
)
from ..core.galois import Ring
from ..core.gcsa import CSACode, GCSACode, gcsa_cost_model
from ..core.polyops import DECODE_CACHE_SIZE
from ..core.secure import SecureBatchEPRMFE, SecureEP
from ..core.single_rmfe import EPRMFE_I, EPRMFE_II

__all__ = [
    "ProblemSpec",
    "CdmmScheme",
    "SchemeFamily",
    "register_scheme",
    "get_scheme",
    "registered_schemes",
    "EPCosts",
    "EPSchemeAdapter",
    "PlainCDMMAdapter",
    "EPRMFE1Adapter",
    "EPRMFE2Adapter",
    "BatchRMFEAdapter",
    "CSAAdapter",
    "GCSAGeneralAdapter",
    "SecureEPAdapter",
    "SecureBatchRMFEAdapter",
]


@dataclass(frozen=True)
class ProblemSpec:
    """One (batch) matrix-multiplication problem to be coded.

    ``n`` products of shape ``(t, r) @ (r, s)`` over the data ring ``ring``,
    distributed over ``N`` workers of which up to ``straggler_budget`` may
    never respond (so the chosen scheme needs R <= N - straggler_budget).
    ``privacy_t > 0`` demands T-collusion privacy (secure families only).
    """

    t: int
    r: int
    s: int
    n: int = 1
    ring: Optional[Ring] = None
    N: int = 8
    straggler_budget: int = 0
    privacy_t: int = 0

    def validate(self) -> None:
        if self.ring is None:
            raise ValueError("ProblemSpec.ring is required")
        if min(self.t, self.r, self.s, self.n) < 1:
            raise ValueError(f"degenerate problem shape {self}")
        if self.N < 1:
            raise ValueError(f"need at least one worker, got N={self.N}")
        if not 0 <= self.straggler_budget < self.N:
            raise ValueError(
                f"straggler_budget={self.straggler_budget} out of [0, N={self.N})"
            )
        if self.privacy_t < 0:
            raise ValueError(f"privacy_t={self.privacy_t} must be >= 0")
        if self.privacy_t > 0:
            # cheapest secure configuration is u=v=w=1: R = 2T + 1
            min_R = secure_recovery_threshold(1, 1, 1, self.privacy_t)
            if min_R > self.N - self.straggler_budget:
                raise ValueError(
                    f"privacy_t={self.privacy_t} needs recovery threshold "
                    f">= {min_R} but straggler_budget="
                    f"{self.straggler_budget} leaves only "
                    f"N - budget = {self.N - self.straggler_budget} "
                    f"guaranteed responders; raise N or relax the budgets"
                )

    def with_batch(self, n: int) -> "ProblemSpec":
        """The same per-request problem at batch arity ``n`` (the seam a
        serving engine coalescing ``n`` requests plans through)."""
        if n < 1:
            raise ValueError(f"batch arity must be >= 1, got {n}")
        return replace(self, n=n)


@runtime_checkable
class CdmmScheme(Protocol):
    """Uniform master/worker surface every registered scheme adapter exposes."""

    name: str
    N: int
    R: int
    ring: Ring  # codeword (extension) ring
    base: Ring  # data ring
    batch: int  # products consumed per execution (1 = single DMM)
    privacy_t: int  # collusion tolerance (0 = no privacy)

    # ``key``: mask randomness, required by secure schemes, ignored by the rest
    def encode_a(self, A: torch.Tensor, key: Optional[int] = None) -> torch.Tensor: ...

    def encode_b(self, B: torch.Tensor, key: Optional[int] = None) -> torch.Tensor: ...

    def encode_a_at(self, A: torch.Tensor, i: int, key: Optional[int] = None) -> torch.Tensor: ...

    def encode_b_at(self, B: torch.Tensor, i: int, key: Optional[int] = None) -> torch.Tensor: ...

    def worker_compute(self, FA: torch.Tensor, GB: torch.Tensor) -> torch.Tensor: ...

    def decode(self, H: torch.Tensor, idx: torch.Tensor) -> torch.Tensor: ...

    def decode_op(self, idx: Tuple[int, ...]) -> Callable[[torch.Tensor], torch.Tensor]: ...

    def costs(self, spec: ProblemSpec) -> EPCosts: ...


class DecodeOpsMixin:
    """Shared ``decode_op``: a decoder for exactly one live set.

    ``decode_op((3, 5, 6))`` returns ``dec(H_subset) -> C`` where
    ``H_subset`` stacks the responses of workers 3, 5, 6 in that order.
    Closures are LRU-cached per scheme instance by the index tuple, with
    the bound of the codes' per-live-set decode matrices.
    """

    DECODE_OP_CACHE_SIZE = DECODE_CACHE_SIZE
    privacy_t = 0  # non-secure default

    def decode_op(self, idx: Tuple[int, ...]) -> Callable[[torch.Tensor], torch.Tensor]:
        idx = tuple(int(i) for i in idx)
        if len(idx) != self.R:
            raise ValueError(
                f"{self.name}: decode_op needs exactly R={self.R} live "
                f"workers, got {len(idx)}"
            )
        if len(set(idx)) != len(idx) or not all(0 <= i < self.N for i in idx):
            raise ValueError(f"{self.name}: invalid live set {idx} for N={self.N}")
        cache = self.__dict__.setdefault("_decode_ops", OrderedDict())
        op = cache.pop(idx, None)
        if op is None:

            def op(H, _idx=idx):
                # the live set stays a host tuple: no device read per call
                return self.decode(H, _idx)

            while len(cache) >= self.DECODE_OP_CACHE_SIZE:
                cache.popitem(last=False)
        cache[idx] = op  # re-insert = mark most-recently-used
        return op

    def __getstate__(self) -> dict:
        # the op cache holds closures, which do not pickle; a scheme sent to
        # the ranks of a RankPool rebuilds its ops on first use
        state = dict(self.__dict__)
        state.pop("_decode_ops", None)
        return state


# ---------------------------------------------------------------------------
# adapters over the scheme classes
# ---------------------------------------------------------------------------


class EPSchemeAdapter(DecodeOpsMixin):
    """Plain EP code: data already lives in a ring with >= N points."""

    name = "ep"

    def __init__(self, ring: Ring, N: int, u: int, v: int, w: int, device=None):
        self.code = EPCode(ring, N, u, v, w, device=device)
        self.base = ring
        self.ring = ring
        self.N, self.R, self.batch = N, self.code.R, 1
        self.partition = (u, v, w)

    def encode_a(self, A, key=None):
        return self.code.encode_a(A)

    def encode_b(self, B, key=None):
        return self.code.encode_b(B)

    def encode_a_at(self, A, i, key=None):
        return self.code.encode_a_at(A, i)

    def encode_b_at(self, B, i, key=None):
        return self.code.encode_b_at(B, i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.code.decode(H, idx)

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.code.costs(spec.t, spec.r, spec.s, self.base)


class PlainCDMMAdapter(DecodeOpsMixin):
    """Lemma III.1 baseline: embed the base ring into an extension, run EP."""

    name = "plain"

    def __init__(self, base: Ring, N: int, u: int, v: int, w: int, device=None):
        self.inner = PlainCDMM(base, N, u, v, w, device=device)
        self.code = self.inner.code
        self.base = base
        self.ring = self.inner.ext
        self.N, self.R, self.batch = N, self.inner.R, 1
        self.partition = (u, v, w)

    def encode_a(self, A, key=None):
        return self.code.encode_a(self.ring.embed_base(A, self.base))

    def encode_b(self, B, key=None):
        return self.code.encode_b(self.ring.embed_base(B, self.base))

    def encode_a_at(self, A, i, key=None):
        return self.code.encode_a_at(self.ring.embed_base(A, self.base), i)

    def encode_b_at(self, B, i, key=None):
        return self.code.encode_b_at(self.ring.embed_base(B, self.base), i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        # products of embedded elements stay in the embedded base ring
        return self.code.decode(H, idx)[..., : self.base.D]

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.inner.costs(spec.t, spec.r, spec.s)


class EPRMFE1Adapter(DecodeOpsMixin):
    """EP_RMFE-I (Cor IV.1): MatDot-style split of r into n RMFE-packed
    sub-products; decode sums them back into one C."""

    name = "ep_rmfe1"

    def __init__(self, base: Ring, n: int, N: int, u: int, v: int, w: int, device=None):
        self.inner = EPRMFE_I(base, n, N, u, v, w, device=device)
        self.code = self.inner.code
        self.base, self.n = base, n
        self.ring = self.inner.ext
        self.N, self.R, self.batch = N, self.inner.R, 1
        self.partition = (u, v, w)

    def _pack_a(self, A):
        return self.inner.batch.pack(self.inner.split_a(A))

    def _pack_b(self, B):
        return self.inner.batch.pack(self.inner.split_b(B))

    def encode_a(self, A, key=None):
        return self.code.encode_a(self._pack_a(A))

    def encode_b(self, B, key=None):
        return self.code.encode_b(self._pack_b(B))

    def encode_a_at(self, A, i, key=None):
        return self.code.encode_a_at(self._pack_a(A), i)

    def encode_b_at(self, B, i, key=None):
        return self.code.encode_b_at(self._pack_b(B), i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        Cs = self.inner.batch.decode(H, idx)  # (n, t, s, D0)
        acc = Cs[0]
        for i in range(1, self.n):
            acc = self.base.add(acc, Cs[i])
        return acc

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.inner.costs(spec.t, spec.r, spec.s)


class EPRMFE2Adapter(DecodeOpsMixin):
    """EP_RMFE-II (Cor IV.2), in the paper's measured §V configuration:
    B column-split and packed through phi_1, A embedded (split_a=False)."""

    name = "ep_rmfe2"

    def __init__(
        self, base: Ring, n: int, N: int, u: int, v: int, w: int,
        split_a: bool = False, device=None,
    ):
        self.inner = EPRMFE_II(base, n, N, u, v, w, split_a=split_a, device=device)
        self.code = self.inner.code
        self.base, self.n = base, n
        self.ring = self.inner.top
        self.N, self.R, self.batch = N, self.inner.R, 1
        self.partition = (u, v, w)

    def encode_a(self, A, key=None):
        return self.code.encode_a(self.inner.pack_a(A))

    def encode_b(self, B, key=None):
        return self.code.encode_b(self.inner.pack_b(B))

    def encode_a_at(self, A, i, key=None):
        return self.code.encode_a_at(self.inner.pack_a(A), i)

    def encode_b_at(self, B, i, key=None):
        return self.code.encode_b_at(self.inner.pack_b(B), i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.inner.unpack(self.code.decode(H, idx))

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.inner.costs(spec.t, spec.r, spec.s)


class BatchRMFEAdapter(DecodeOpsMixin):
    """Batch-EP_RMFE (Thm III.2): n products packed positionwise into one
    extension-ring product."""

    name = "batch_ep_rmfe"

    def __init__(self, base: Ring, n: int, N: int, u: int, v: int, w: int, device=None):
        self.inner = BatchEPRMFE(base, n, N, u, v, w, device=device)
        self.code = self.inner.code
        self.base = base
        self.ring = self.inner.ext
        self.N, self.R = N, self.inner.R
        self.batch = self.inner.rmfe.n  # actual packed batch (>= requested n)
        self.partition = (u, v, w)

    def encode_a(self, As, key=None):
        return self.code.encode_a(self.inner.pack(As))

    def encode_b(self, Bs, key=None):
        return self.code.encode_b(self.inner.pack(Bs))

    def encode_a_at(self, As, i, key=None):
        return self.code.encode_a_at(self.inner.pack(As), i)

    def encode_b_at(self, Bs, i, key=None):
        return self.code.encode_b_at(self.inner.pack(Bs), i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.inner.decode(H, idx)

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.inner.costs(spec.t, spec.r, spec.s)


class CSAAdapter(DecodeOpsMixin):
    """Executable GCSA point (u=v=w=1, kappa=n): the CSA batch code, run
    over the smallest embedding extension with >= n + N exceptional points."""

    name = "gcsa"

    def __init__(self, base: Ring, n: int, N: int, device=None):
        ext = smallest_embedding_ext(base, n + N)
        self.base, self.ring = base, ext
        self.code = CSACode(ext, L=n, N=N, device=device)
        self.N, self.R, self.batch = N, self.code.R, n
        self.partition = (1, 1, 1)

    def encode_a(self, As, key=None):
        return self.code.encode_a(self.ring.embed_base(As, self.base))

    def encode_b(self, Bs, key=None):
        return self.code.encode_b(self.ring.embed_base(Bs, self.base))

    def encode_a_at(self, As, i, key=None):
        return self.code.encode_a_at(self.ring.embed_base(As, self.base), i)

    def encode_b_at(self, Bs, i, key=None):
        return self.code.encode_b_at(self.ring.embed_base(Bs, self.base), i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.code.decode(H, idx)[..., : self.base.D]

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.code.costs(spec)


class GCSAGeneralAdapter(DecodeOpsMixin):
    """Executable general-(u, v, w, kappa) GCSA over the smallest embedding
    extension with >= n + N exceptional points; R = uvw(n + kappa - 1) +
    w - 1.  The registry's packing slot carries kappa (any divisor of the
    batch), so the planner sweeps group sizes."""

    name = "gcsa_general"

    def __init__(
        self, base: Ring, n: int, N: int, u: int, v: int, w: int, kappa: int, device=None,
    ):
        ext = smallest_embedding_ext(base, n + N)
        self.base, self.ring = base, ext
        self.code = GCSACode(ext, L=n, N=N, u=u, v=v, w=w, kappa=kappa, device=device)
        self.N, self.R, self.batch = N, self.code.R, n
        self.partition = (u, v, w)
        self.kappa = kappa

    def encode_a(self, As, key=None):
        return self.code.encode_a(self.ring.embed_base(As, self.base))

    def encode_b(self, Bs, key=None):
        return self.code.encode_b(self.ring.embed_base(Bs, self.base))

    def encode_a_at(self, As, i, key=None):
        return self.code.encode_a_at(self.ring.embed_base(As, self.base), i)

    def encode_b_at(self, Bs, i, key=None):
        return self.code.encode_b_at(self.ring.embed_base(Bs, self.base), i)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.code.decode(H, idx)[..., : self.base.D]

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.code.costs(spec)


class SecureEPAdapter(DecodeOpsMixin):
    """T-private EP code (secure single DMM): the base ring is embedded into
    the smallest extension with >= N + 1 exceptional points and a masked EP
    code runs there.  ``encode_*`` REQUIRE an integer key."""

    name = "ep_secure"

    def __init__(self, base: Ring, N: int, u: int, v: int, w: int, T: int, device=None):
        self.inner = SecureEP(base, N, u, v, w, T, device=device)
        self.code = self.inner.code
        self.base = base
        self.ring = self.inner.ext
        self.N, self.R, self.batch = N, self.inner.R, 1
        self.privacy_t = T
        self.partition = (u, v, w)

    def encode_a(self, A, key=None):
        return self.code.encode_a(self.inner.embed(A), key=key)

    def encode_b(self, B, key=None):
        return self.code.encode_b(self.inner.embed(B), key=key)

    def encode_a_at(self, A, i, key=None):
        return self.code.encode_a_at(self.inner.embed(A), i, key=key)

    def encode_b_at(self, B, i, key=None):
        return self.code.encode_b_at(self.inner.embed(B), i, key=key)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.inner.decode(H, idx)

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.inner.costs(spec.t, spec.r, spec.s)


class SecureBatchRMFEAdapter(DecodeOpsMixin):
    """T-private Batch-EP_RMFE (secure batch DMM): n products RMFE-packed
    into one extension-ring product, computed by a masked EP code whose
    extension carries >= N + 1 exceptional points."""

    name = "ep_rmfe_secure"

    def __init__(
        self, base: Ring, n: int, N: int, u: int, v: int, w: int, T: int, device=None,
    ):
        self.inner = SecureBatchEPRMFE(base, n, N, u, v, w, T, device=device)
        self.code = self.inner.code
        self.base = base
        self.ring = self.inner.ext
        self.N, self.R = N, self.inner.R
        self.batch = self.inner.rmfe.n  # actual packed batch (>= requested n)
        self.privacy_t = T
        self.partition = (u, v, w)

    def encode_a(self, As, key=None):
        return self.code.encode_a(self.inner.pack(As), key=key)

    def encode_b(self, Bs, key=None):
        return self.code.encode_b(self.inner.pack(Bs), key=key)

    def encode_a_at(self, As, i, key=None):
        return self.code.encode_a_at(self.inner.pack(As), i, key=key)

    def encode_b_at(self, Bs, i, key=None):
        return self.code.encode_b_at(self.inner.pack(Bs), i, key=key)

    def worker_compute(self, FA, GB):
        return self.code.worker_compute(FA, GB)

    def decode(self, H, idx):
        return self.inner.decode(H, idx)

    def costs(self, spec: ProblemSpec) -> EPCosts:
        return self.inner.costs(spec.t, spec.r, spec.s)


# ---------------------------------------------------------------------------
# analytic feasibility / cost prediction (no host-side construction)
# ---------------------------------------------------------------------------


def _coprime_bump(m: int, D0: int) -> int:
    """Mirror Ring.extend: smallest m' >= m with gcd(m', D0) == 1."""
    while gcd(m, D0) != 1:
        m += 1
    return m


def _embed_ext_D(p: int, D0: int, npoints: int) -> int:
    """Tower degree of the smallest embedding extension with >= npoints
    exceptional points (analytic mirror of ``smallest_embedding_ext``)."""
    if p**D0 >= npoints:
        return D0
    m = 1
    while p ** (D0 * m) < npoints:
        m += 1
    D = D0 * _coprime_bump(m, D0)
    while p**D < npoints:
        m += 1
        D = D0 * _coprime_bump(m, D0)
    return D


def _rmfe_ext_D(p: int, D0: int, n: int, min_m: int):
    """(tower degree, actual packed batch) of build_rmfe(base, n, min_m)."""
    T = p**D0
    if n <= T:
        return D0 * _coprime_bump(max(2 * n - 1, min_m, 2), D0), n
    n2 = T
    n1 = -(-n // n2)
    midD = D0 * _coprime_bump(max(2 * n2 - 1, 2), D0)
    return midD * _coprime_bump(max(2 * n1 - 1, 2), midD), n1 * n2


def _min_m_for_points(p: int, D0: int, N: int) -> int:
    return ceil(log(max(N, 2)) / (log(p) * D0))


def _predict_ep(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    if n != 1 or p**D0 < spec.N:
        return None
    if spec.t % u or spec.r % w or spec.s % v:
        return None
    return ep_cost_model(spec.t, spec.r, spec.s, u, v, w, spec.N, m_eff=1.0)


def _predict_plain(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    if n != 1:
        return None
    if spec.t % u or spec.r % w or spec.s % v:
        return None
    m_eff = _embed_ext_D(p, D0, spec.N) / D0
    return ep_cost_model(spec.t, spec.r, spec.s, u, v, w, spec.N, m_eff=m_eff)


def _predict_rmfe1(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    if n < 2 or spec.r % n:
        return None
    rb = spec.r // n
    if spec.t % u or rb % w or spec.s % v:
        return None
    extD, actual = _rmfe_ext_D(p, D0, n, _min_m_for_points(p, D0, spec.N))
    if actual != n or p**extD < spec.N:
        return None
    # one EP run on (t, r/n, s): the r-shrink carries the 1/n saving
    return ep_cost_model(spec.t, rb, spec.s, u, v, w, spec.N, extD / D0)


def _predict_rmfe2(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    # split_a=False configuration: level-1 RMFE needs n <= |T(base)|
    if n < 2 or n > p**D0 or spec.s % n:
        return None
    sb = spec.s // n
    if spec.t % u or spec.r % w or sb % v:
        return None
    min_m = _min_m_for_points(p, D0, spec.N)
    midD = D0 * _coprime_bump(max(2 * n - 1, min_m, 2), D0)
    if p**midD < spec.N:
        return None
    return ep_cost_model(spec.t, spec.r, sb, u, v, w, spec.N, midD / D0)


def _predict_batch(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    if n != spec.n:
        return None
    if spec.t % u or spec.r % w or spec.s % v:
        return None
    extD, actual = _rmfe_ext_D(p, D0, n, _min_m_for_points(p, D0, spec.N))
    if actual != n or p**extD < spec.N:
        return None
    return ep_cost_model(
        spec.t, spec.r, spec.s, u, v, w, spec.N, extD / D0, batch=n
    )


def _predict_gcsa(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    # executable CSA point: (u, v, w) = (1, 1, 1), kappa = n
    if (u, v, w) != (1, 1, 1) or n != spec.n:
        return None
    m_eff = _embed_ext_D(p, D0, spec.N + n) / D0
    return gcsa_cost_model(spec.t, spec.r, spec.s, 1, 1, 1, n, n, spec.N, m_eff)


def _gcsa_packings(spec: ProblemSpec) -> Tuple[int, ...]:
    """Packing candidates for gcsa_general: the group size kappa, any
    divisor of the batch (kappa = n recovers the CSA point)."""
    return tuple(d for d in range(1, spec.n + 1) if spec.n % d == 0)


def _predict_gcsa_general(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    kappa = n  # the packing slot carries the group size
    if spec.n < 2 or kappa < 1 or spec.n % kappa:
        return None
    if spec.t % u or spec.r % w or spec.s % v:
        return None
    m_eff = _embed_ext_D(p, D0, spec.N + spec.n) / D0
    return gcsa_cost_model(spec.t, spec.r, spec.s, u, v, w, spec.n, kappa, spec.N, m_eff)


def _predict_ep_secure(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    T = spec.privacy_t
    if T < 1 or n != 1:
        return None  # secure families only serve privacy_t >= 1 specs
    if spec.t % u or spec.r % w or spec.s % v:
        return None
    # evaluation skips the zero point, so the embedding needs N + 1 points
    m_eff = _embed_ext_D(p, D0, spec.N + 1) / D0
    return ep_cost_model(spec.t, spec.r, spec.s, u, v, w, spec.N, m_eff, privacy_t=T)


def _predict_rmfe_secure(spec: ProblemSpec, u, v, w, n) -> Optional[EPCosts]:
    p, D0 = spec.ring.p, spec.ring.D
    T = spec.privacy_t
    if T < 1 or n != spec.n:
        return None
    if spec.t % u or spec.r % w or spec.s % v:
        return None
    extD, actual = _rmfe_ext_D(p, D0, n, _min_m_for_points(p, D0, spec.N + 1))
    if actual != n or p**extD < spec.N + 1:
        return None
    return ep_cost_model(
        spec.t, spec.r, spec.s, u, v, w, spec.N, extD / D0, batch=n, privacy_t=T,
    )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SchemeFamily:
    """A registered scheme family.

    ``batched`` families consume ``spec.n`` products per execution; single
    families consume one product (their ``n`` is an internal packing factor).
    ``predict(spec, u, v, w, n)`` returns the analytic EPCosts or None when
    the configuration is infeasible; ``build(spec, u, v, w, n, device)``
    constructs the executable adapter.

    ``packing`` (optional) enumerates the family's candidate values for the
    4th build/predict parameter given a spec.  When absent the planner uses
    its defaults: ``(spec.n,)`` for batched families, divisors of the
    operand dimensions for single families.  ``gcsa_general`` reads it as
    the group size kappa and supplies it.
    """

    name: str
    batched: bool
    build: Callable[..., CdmmScheme]
    predict: Callable[[ProblemSpec, int, int, int, int], Optional[EPCosts]]
    packing: Optional[Callable[[ProblemSpec], Iterable[int]]] = None


_REGISTRY: Dict[str, SchemeFamily] = {}


def register_scheme(family: SchemeFamily) -> SchemeFamily:
    _REGISTRY[family.name] = family
    return family


def get_scheme(name: str) -> SchemeFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scheme {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def registered_schemes() -> Dict[str, SchemeFamily]:
    return dict(_REGISTRY)


register_scheme(SchemeFamily(
    "ep", False,
    lambda spec, u, v, w, n, device=None: EPSchemeAdapter(
        spec.ring, spec.N, u, v, w, device=device
    ),
    _predict_ep,
))
register_scheme(SchemeFamily(
    "plain", False,
    lambda spec, u, v, w, n, device=None: PlainCDMMAdapter(
        spec.ring, spec.N, u, v, w, device=device
    ),
    _predict_plain,
))
register_scheme(SchemeFamily(
    "ep_rmfe1", False,
    lambda spec, u, v, w, n, device=None: EPRMFE1Adapter(
        spec.ring, n, spec.N, u, v, w, device=device
    ),
    _predict_rmfe1,
))
register_scheme(SchemeFamily(
    "ep_rmfe2", False,
    lambda spec, u, v, w, n, device=None: EPRMFE2Adapter(
        spec.ring, n, spec.N, u, v, w, device=device
    ),
    _predict_rmfe2,
))
register_scheme(SchemeFamily(
    "batch_ep_rmfe", True,
    lambda spec, u, v, w, n, device=None: BatchRMFEAdapter(
        spec.ring, n, spec.N, u, v, w, device=device
    ),
    _predict_batch,
))
register_scheme(SchemeFamily(
    "gcsa", True,
    lambda spec, u, v, w, n, device=None: CSAAdapter(spec.ring, n, spec.N, device=device),
    _predict_gcsa,
))
register_scheme(SchemeFamily(
    "gcsa_general", True,
    lambda spec, u, v, w, n, device=None: GCSAGeneralAdapter(
        spec.ring, spec.n, spec.N, u, v, w, n, device=device
    ),
    _predict_gcsa_general,
    packing=_gcsa_packings,
))
register_scheme(SchemeFamily(
    "ep_secure", False,
    lambda spec, u, v, w, n, device=None: SecureEPAdapter(
        spec.ring, spec.N, u, v, w, spec.privacy_t, device=device
    ),
    _predict_ep_secure,
))
register_scheme(SchemeFamily(
    "ep_rmfe_secure", True,
    lambda spec, u, v, w, n, device=None: SecureBatchRMFEAdapter(
        spec.ring, n, spec.N, u, v, w, spec.privacy_t, device=device
    ),
    _predict_rmfe_secure,
))
