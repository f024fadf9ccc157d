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

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "gr_matmul_ref",
    "gr_matmul_planar_ref",
    "gr_matmul_limbs_ref",
    "gr_matmul_simt_ref",
    "gr_matmul_tc_left_ref",
    "gr_matmul_tc_ref",
    "gr_matmul_tower_ref",
    "left_lift_ref",
    "lift_b_ref",
    "limb_planes_ref",
    "mult_matrices_ref",
    "n_limbs",
    "outer_reduction",
    "stacked_planes_ref",
    "tc_left_padded",
    "tc_left_planes_ref",
    "tc_left_tiles_ref",
    "tc_lifted",
    "tc_planes_ref",
    "tc_view",
    "thin_lift_ref",
    "to_i32",
    "u32_to_signed",
]

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


def _fold(conv, ring) -> torch.Tensor:
    """out[d] = sum_c FOLD[c, d] * conv[c], reduced and masked; conv: list of
    K int64 planes (..., t, s) -> (..., D, t, s) in the ring's storage."""
    planes = []
    for d in range(ring.D):
        acc = None
        for c in range(ring.K):
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
    return _fold(conv, ring)


def gr_matmul_ref(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Interleaved layout: (..., t, r, D) x (..., r, s, D) -> (..., t, s, D)."""
    C = gr_matmul_planar_ref(A.movedim(-1, -3), B.movedim(-1, -3), ring)
    return C.movedim(-3, -1)


# -- the tensor-core route's arithmetic, in plain PyTorch ----------------------


def n_limbs(ring) -> int:
    """L = ceil(e / 8): unsigned 8-bit limbs per element of GR(2^e, D)."""
    return -(-ring.e // 8)


def limb_planes_ref(X: torch.Tensor, ring, rows: int, cols: int,
                    transpose: bool = False) -> torch.Tensor:
    """Plain version of the ``tc`` route's limb pre-pass.

    X (..., x, y, D) int32 -> (..., D, L, rows, cols) uint8: plane (d, l)
    holds byte l of coefficient d, as (x, y) or, with ``transpose``, (y, x),
    zero-padded to (rows, cols).  A (t, r, D) gives its K-major planes
    without ``transpose``, B (r, s, D) with it.
    """
    P = X.movedim(-1, -3)
    if transpose:
        P = P.transpose(-1, -2)
    P = P.to(torch.int64) & _U32
    L = n_limbs(ring)
    planes = torch.stack([(P >> (8 * l)) & 0xFF for l in range(L)], dim=-3)
    planes = F.pad(planes, (0, cols - planes.shape[-1], 0, rows - planes.shape[-2]))
    return planes.to(torch.uint8)


def gr_matmul_limbs_ref(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """The ``tc`` route's algorithm on the CPU (int64 matmuls stand in for
    the int8 MMAs): (..., t, r, D) x (..., r, s, D) -> (..., t, s, D).

    Each operand is split into L = ceil(e/8) unsigned bytes, so mod 2^e
    ``a * b = sum_{x+y<L} 2^(8(x+y)) a_x b_y``.  The limb products of every
    (i, j, x, y) with CONVPOS[i, j] = c and x + y = s are chained over all
    of r into one accumulator (c, s), which wraps mod 2^32 as the kernel's
    int32 wgmma accumulator does; then ``conv[c] = sum_s acc(c, s) << 8s
    (mod 2^32)``, folded and masked as the plain version does.  No flush:
    wrapping keeps every step exact mod 2^32.  Only for p = 2, e <= 32.
    """
    assert ring.p == 2 and ring.e <= 32, ring
    t, r = A.shape[-3], A.shape[-2]
    s = B.shape[-2]
    L = n_limbs(ring)
    A8 = limb_planes_ref(A, ring, t, r).to(torch.int64)  # (..., D, L, t, r)
    B8 = limb_planes_ref(B, ring, s, r, transpose=True).to(torch.int64)  # (..., D, L, s, r)
    acc = {}
    for i in range(ring.D):
        for j in range(ring.D):
            c = int(ring.CONVPOS[i, j])
            for x in range(L):
                for y in range(L - x):
                    p = A8[..., i, x, :, :] @ B8[..., j, y, :, :].transpose(-1, -2)
                    acc[c, x + y] = (acc[c, x + y] + p if (c, x + y) in acc else p) & _U32
    conv = [torch.zeros(A.shape[:-3] + (t, s), dtype=torch.int64) for _ in range(ring.K)]
    for (c, sh), a in acc.items():
        conv[c] = (conv[c] + (a << (8 * sh))) & _U32
    return _fold(conv, ring).movedim(-3, -1)


# -- the simt route's thin kernel: M(A) lifted a stage at a time, mma.sync -----

# rows of r a stage of the thin kernel (mirrors kBK in csrc/gr_matmul.cu)
SIMT_THIN_DEPTH = 32


def thin_lift_ref(A: torch.Tensor, ring) -> torch.Tensor:
    """M(A) as the ``simt`` thin kernel lifts it: A (..., t, r, D) over a
    single-level GR(2^e, D) -> (..., t, r, k, m) int64 in [0, 2^32),
    M(a)[k, m] = (x^k a)_m by the recurrence x^(k+1) a = x (x^k a): shift
    the coefficients up one place and add the top one times x^D, FOLD's row
    D (D - 1 multiply-adds a coefficient, mod 2^32)."""
    D = ring.D
    v = A.to(torch.int64) & _U32
    cols = [v]
    if D > 1:
        xd = torch.tensor([u32_to_signed(int(c)) for c in ring.FOLD_U32[D]], dtype=torch.int64,
                          device=A.device)
    for _ in range(1, D):
        # signed 32-bit lifts of both factors: |product| < 2^62
        top = to_i32(v[..., D - 1:]).to(torch.int64)
        v = (F.pad(v[..., :-1], (1, 0)) + ((top * xd) & _U32)) & _U32
        cols.append(v)
    return torch.stack(cols, dim=-2)


def gr_matmul_simt_ref(A: torch.Tensor, B: torch.Tensor, ring, splits=None,
                       sms: int = 132) -> torch.Tensor:
    """The ``simt`` route's arithmetic on the CPU: (..., t, r, D) x (..., r,
    s, D) -> (..., t, s, D), as the kernel ``gr_matmul.simt_thin`` picks
    runs it.

    The thin kernel (t <= 64 over GR(2^e, D <= 4)): every word of M(A)
    (:func:`thin_lift_ref`, rows (t, m), depth (k, r)) and of B (depth
    (k, r), B[r, s, k]) split into L = ceil(e / 8) bytes; R in stages of 32
    rows, split into ``splits`` balanced runs of whole stages (None: the
    count ``gr_matmul.simt_grid`` picks on a card of ``sms`` SMs); in each
    run one accumulator a limb shift x + y < L takes every byte product of
    that shift, wrapping mod 2^32 as the kernel's s32 accumulators do; the
    run's part is sum_shift acc << 8 shift (mod 2^32), the runs' parts are
    summed wrapping mod 2^32 (the kernel's atomics) and the e-bit mask is
    applied once, at the end.

    The tile kernel (every other call): the conv accumulators wrap mod 2^32,
    FOLD folds them and the mask is applied, as :func:`gr_matmul_ref`
    computes (its arithmetic is that function's)."""
    from .gr_matmul import simt_grid, simt_thin  # gr_matmul imports this module

    t, r, s = A.shape[-3], A.shape[-2], B.shape[-2]
    if not simt_thin(ring, t):
        return gr_matmul_ref(A, B, ring)
    assert ring.p == 2 and ring.e <= 32, ring
    b = 1
    for x in A.shape[:-3]:
        b *= x
    if splits is None:
        splits = simt_grid(ring, b, t, r, s, sms)[4]
    L = n_limbs(ring)
    M = thin_lift_ref(A, ring)  # (..., t, r, k, m)
    Bw = B.to(torch.int64) & _U32  # (..., r, s, k)
    n_st = -(-r // SIMT_THIN_DEPTH)
    total = torch.zeros(A.shape[:-3] + (t, s, ring.D), dtype=torch.int64, device=A.device)
    for sp in range(splits):
        lo = sp * n_st // splits * SIMT_THIN_DEPTH
        hi = min(r, (sp + 1) * n_st // splits * SIMT_THIN_DEPTH)
        Ma, Bb = M[..., lo:hi, :, :], Bw[..., lo:hi, :, :]
        part = torch.zeros_like(total)
        for sh in range(L):
            acc = torch.zeros_like(total)
            for x in range(sh + 1):
                a8 = (Ma >> (8 * x)) & 0xFF
                b8 = (Bb >> (8 * (sh - x))) & 0xFF
                acc = acc + torch.einsum("...trkm,...rsk->...tsm", a8, b8)
            part = (part + ((acc & _U32) << (8 * sh))) & _U32
        total = (total + part) & _U32
    out = to_i32(total)
    return out & ring._mask if ring._mask is not None else out


# -- the tensor-core route over a lifted ring: the outer-level lift ------------

# the tc kernel's own instantiations stop at D = 4 (kMaxD in
# csrc/gr_matmul_tc.cu): a single-level ring above it is lifted
TC_MAX_D = 4


def tc_view(d0: int, d1: int = 1) -> Tuple[int, int]:
    """(D0, D1): the tower the ``tc`` route runs a ring of tower shape
    (d0, d1) as.  A two-level tower is itself, lifted onto its inner ring
    GR(2^e, D0) when D1 > 1; a single-level ring GR(2^e, D) with D > 4 is
    the tower (1, D), lifted onto Z_2^e (its FOLD = kron(FOLD, [[1]]), so
    the outer reduction is FOLD itself); GR(2^e, D <= 4) is (D, 1)."""
    return (1, d0) if d1 == 1 and d0 > TC_MAX_D else (d0, d1)


def _view(ring) -> Tuple[int, int]:
    deg = ring.degrees
    return tc_view(*deg) if len(deg) == 2 else tc_view(ring.D)


def tc_lifted(ring) -> bool:
    """Whether the ``tc`` route lifts ``ring``'s B (``lift_b_ref``): a
    two-level tower, or a single-level ring with D > 4."""
    return _view(ring)[1] > 1


def outer_reduction(ring):
    """RED (2 D1 - 1, D1) uint32 of a lifted ring (D0, D1) (:func:`tc_view`):
    row k holds the outer variable's x^k reduced by the outer modulus over
    Z_q.  FOLD is kron(RED, FOLD0) and FOLD0[0, 0] = 1, so RED is FOLD's
    (c * K0, m * D0) entries (K0 = 2 D0 - 1); for a single-level ring
    (D0 = 1) it is FOLD itself."""
    d0 = _view(ring)[0]
    return ring.FOLD_U32[:: 2 * d0 - 1, ::d0]


def lift_b_ref(B: torch.Tensor, ring) -> torch.Tensor:
    """Plain version of the ``tc`` route's lift over a lifted ring (D0, D1)
    (:func:`tc_view`): B (..., r, s, D0 D1) -> M(B) (..., D1 r, D1 s, D0)
    int32,

        M(B)[(r, i), (s, m)] = sum_j RED[i + j, m] * B[r, s, j]  (mod 2^32),

    each B[r, s, j] an element of the inner ring GR(2^e, D0) (Z_2^e for a
    single-level ring).  Then ``A (t, r, D)`` read as ``(t, D1 r, D0)``
    times M(B) over the inner ring is A B over the ring, read as
    ``(t, D1 s, D0)``."""
    d0, d1 = _view(ring)
    *lead, r, s, _ = B.shape
    Bt = B.to(torch.int64).reshape(*lead, r, s, d1, d0)
    red = torch.tensor([[u32_to_signed(int(v)) for v in row] for row in outer_reduction(ring)],
                       dtype=torch.int64, device=B.device)
    M = torch.zeros((*lead, r, d1, s, d1, d0), dtype=torch.int64, device=B.device)
    for i in range(d1):
        for j in range(d1):
            # signed 32-bit lifts of both factors: |product| < 2^62
            M[..., i, :, :, :] += (Bt[..., j, None, :] * red[i + j][:, None]) & _U32
    return to_i32(M).reshape(*lead, d1 * r, d1 * s, d0)


def tc_planes_ref(A: torch.Tensor, B: torch.Tensor, ring, Tp: int, Rp: int, Sp: int):
    """Plain version of the ``tc`` route's pre-passes: the limb planes the
    main kernel reads, A8 (..., D0, L, Tp, Rp) and B8 (..., D0, L, Sp, Rp).
    A ring the kernel takes as it is splits both operands as they are
    (D0 = D); a lifted ring (:func:`tc_view`) splits A read as
    (t, D1 r, D0) and the lift M(B)."""
    if not tc_lifted(ring):
        return (limb_planes_ref(A, ring, Tp, Rp),
                limb_planes_ref(B, ring, Sp, Rp, transpose=True))
    inner = ring.base_ring()
    d0, d1 = _view(ring)
    A1 = A.reshape(*A.shape[:-2], d1 * A.shape[-2], d0)
    return (limb_planes_ref(A1, inner, Tp, Rp),
            limb_planes_ref(lift_b_ref(B, ring), inner, Sp, Rp, transpose=True))


def gr_matmul_tc_ref(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """The ``tc`` route's algorithm on the CPU, composed as the route runs
    it: :func:`gr_matmul_limbs_ref` over the ring itself, or over the inner
    ring GR(2^e, D0) of a lifted ring (:func:`tc_view`; Z_2^e for a
    single-level one) on A read as (t, D1 r, D0) and the lift M(B)
    (:func:`lift_b_ref`), whose (t, D1 s, D0) product is the ring's
    (t, s, D)."""
    if not tc_lifted(ring):
        return gr_matmul_limbs_ref(A, B, ring)
    d0, d1 = _view(ring)
    A1 = A.reshape(*A.shape[:-2], d1 * A.shape[-2], d0)
    C1 = gr_matmul_limbs_ref(A1, lift_b_ref(B, ring), ring.base_ring())
    return C1.reshape(*C1.shape[:-2], C1.shape[-2] // d1, ring.D)


# -- the tc_left route: the small left operand lifted over Z_2^e ---------------

# the tc_left kernel's stage depth (bytes of K, one 32-byte swizzle row) and
# the rows of its tiles (one wgmma M), of which it uses floor(64 / D)
# values of t (mirror kDepth and kRows in csrc/gr_matmul_tc_left.cu)
TC_LEFT_DEPTH = 32
TC_LEFT_ROWS = 64


def tc_left_padded(t: int, r: int, s: int) -> Tuple[int, int, int]:
    """(Tp, Rp, Sp): the shape the ``tc_left`` route's limb planes are
    padded to, for its main kernel's (T, R, S) = (D t, D r, s): T and S to
    the pre-passes' 32, R (the depth (r, k)) to the 32-byte stage."""
    up = lambda x, m: -(-x // m) * m  # noqa: E731
    return up(t, 32), up(r, TC_LEFT_DEPTH), up(s, 32)


def left_lift_ref(A: torch.Tensor, ring) -> torch.Tensor:
    """M(A) of the ``tc_left`` route: A (..., t, r, D) -> (..., D t, D r)
    int32 over Z_2^e, M(A)[(t, m), (r, k)] = M(A[t, r])[k, m] =
    sum_i A[t, r, i] FOLD[CONVPOS(i, k), m] (:func:`mult_matrices_ref`),
    so that C[t, s, m] = sum_(r, k) M(A)[(t, m), (r, k)] B[r, s, k]."""
    *lead, t, r, D = A.shape
    M = to_i32(mult_matrices_ref(A, ring))  # (..., t, r, k, m)
    return M.movedim(-1, -3).reshape(*lead, t * D, r * D)


def stacked_planes_ref(B: torch.Tensor, ring, Sp: int, Rp: int) -> torch.Tensor:
    """Plain version of the ``tc_left`` route's stack pre-pass: B (..., r,
    s, D) -> (..., 1, L, Sp, Rp) uint8, the limb planes of B' (rows s,
    depth (r, k)), B'[(r, k), s] = B[r, s, k] over Z_2^e, zero-padded."""
    *lead, r, s, D = B.shape
    Bs = B.movedim(-1, -2).reshape(*lead, r * D, s, 1)
    return limb_planes_ref(Bs, ring, Sp, Rp, transpose=True)


def tc_left_planes_ref(A: torch.Tensor, B: torch.Tensor, ring, Tp: int, Rp: int, Sp: int):
    """Plain version of the ``tc_left`` route's pre-passes: A8 (..., 1, L,
    Tp, Rp), the limb planes of M(A) (:func:`left_lift_ref`, rows (t, m),
    depth (r, k)), and B8 (..., 1, L, Sp, Rp), those of B'
    (:func:`stacked_planes_ref`)."""
    return (limb_planes_ref(left_lift_ref(A, ring)[..., None], ring, Tp, Rp),
            stacked_planes_ref(B, ring, Sp, Rp))


def tc_left_tiles_ref(A8: torch.Tensor, B8: torch.Tensor, ring, t: int, s: int,
                      bn: int) -> torch.Tensor:
    """The ``tc_left`` kernel's tile walk, in plain PyTorch, on its limb
    planes (A8 (..., 1, L, Tp, Rp) of M(A), B8 (..., 1, L, Sp, Rp) of B',
    :func:`tc_left_planes_ref`) -> C (..., t, s, D) int32.  Row tiles hold
    floor(64 / D) whole values of t: a tile reads 64 rows of M(A) from row
    t0 D (zeros past Tp) and drops the rows past its whole t; column tiles
    are ``bn`` wide, the last one ragged.  A tile's accumulator of shift
    a + b (limb a of M(A) against limb b of B') wraps mod 2^32; then
    sum_s acc(s) << 8s, masked, is written as one contiguous run of
    C[t, n0 : n0 + bn] per t."""
    D, L = ring.D, n_limbs(ring)
    tt = TC_LEFT_ROWS // D
    lead = A8.shape[:-4]
    a8, b8 = A8[..., 0, :, :, :].to(torch.int64), B8[..., 0, :, :, :].to(torch.int64)
    C = torch.zeros(lead + (t, s, D), dtype=torch.int32, device=A8.device)
    for t0 in range(0, t, tt):
        At = a8[..., t0 * D: t0 * D + TC_LEFT_ROWS, :]
        At = F.pad(At, (0, 0, 0, TC_LEFT_ROWS - At.shape[-2]))  # TMA's zeros past Tp
        nt = min(tt, t - t0)
        for n0 in range(0, s, bn):
            Bt = b8[..., n0: n0 + bn, :]
            conv = 0
            for a in range(L):
                for b in range(L - a):
                    acc = (At[..., a, :, :] @ Bt[..., b, :, :].transpose(-1, -2)) & _U32
                    conv = (conv + (acc << (8 * (a + b)))) & _U32
            out = to_i32(conv)  # (..., 64, bn): rows (t, m) of the tile
            out = out & ring._mask if ring._mask is not None else out
            runs = out[..., : tt * D, :].unflatten(-2, (tt, D)).transpose(-1, -2)  # (t, bn, m)
            cols = min(bn, s - n0)
            C[..., t0: t0 + nt, n0: n0 + cols, :] = runs[..., :nt, :cols, :]
    return C


def gr_matmul_tc_left_ref(A: torch.Tensor, B: torch.Tensor, ring, bn: int = 64) -> torch.Tensor:
    """The ``tc_left`` route's algorithm on the CPU: (..., t, r, D) x
    (..., r, s, D) -> (..., t, s, D) as

        M(A)[(t, m), (r, k)] = sum_i A[t, r, i] FOLD[CONVPOS(i, k), m]   (D t x D r)
        B'[(r, k), s] = B[r, s, k]                                        (D r x s)
        C[t, s, m] = (M(A) B')[(t, m), s]                        over Z_2^e

    composed as the route runs it: the pre-passes' limb planes at
    :func:`tc_left_padded` (:func:`tc_left_planes_ref`), then the kernel's
    tile walk (:func:`tc_left_tiles_ref`, tiles ``bn`` wide): the lift on
    A, whose rows are few, and B as it lies."""
    D = ring.D
    t, r, s = A.shape[-3], A.shape[-2], B.shape[-2]
    A8, B8 = tc_left_planes_ref(A, B, ring, *tc_left_padded(D * t, D * r, s))
    return tc_left_tiles_ref(A8, B8, ring, t, s, bn)


# -- the tower route: A lifted to its multiplication matrices -------------------


def mult_matrices_ref(A: torch.Tensor, ring) -> torch.Tensor:
    """M(a) (..., D, D) int64 in [0, 2^32) of every element a (..., D):
    ``M(a)[j, k] = sum_i a_i FOLD[CONVPOS(i, j), k]``, so that
    ``(a b)_k = sum_j M(a)[j, k] b_j`` (mod 2^32)."""
    T = torch.tensor([[[u32_to_signed(int(v)) for v in ring.FOLD_U32[c]] for c in row]
                      for row in ring.CONVPOS], dtype=torch.int64, device=A.device)
    A64 = A.to(torch.int64)
    M = torch.zeros(A.shape + (ring.D,), dtype=torch.int64, device=A.device)
    for i in range(ring.D):
        M += (A64[..., i, None, None] * T[i]) & _U32
    return M & _U32


def gr_matmul_tower_ref(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Plain version of the ``tower`` route: (..., t, r, D) x (..., r, s, D)
    -> (..., t, s, D) as ``C[t, s, :] = sum_r M(A[t, r])^T B[r, s, :]``
    (:func:`mult_matrices_ref`): D^2 word products per (t, r, s), no fold.
    Only for p = 2, e <= 32."""
    assert ring.p == 2 and ring.e <= 32, ring
    M = to_i32(mult_matrices_ref(A, ring)).to(torch.int64)  # (..., t, r, D, D)
    B64 = B.to(torch.int64)
    *lead, t, r, _ = A.shape
    out = torch.zeros((*lead, t, B.shape[-2], ring.D), dtype=torch.int64, device=A.device)
    for k in range(r):
        for j in range(ring.D):
            out += (M[..., :, None, k, j, :] * B64[..., None, k, :, j, None]) & _U32
    out = to_i32(out)
    return out & ring._mask if ring._mask is not None else out
