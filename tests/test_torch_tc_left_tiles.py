"""The ``tc_left`` kernel's layout, as its plain versions, on the CPU.

The route's own kernel (``csrc/gr_matmul_tc_left.cu``) multiplies A's
multiplication matrices M(A) (D t x D r over Z_2^e) by B read as (D r, s),
walking row tiles of floor(64 / D) whole values of t, so that each tile's
output is one contiguous run of C[t, n0 : n0 + bn] per t, over limb planes
whose depth (r, k) is padded to its 32-byte stage (``tc_left_padded``);
the stack pre-pass covers all of a call's rows of r in one block where
they fit.
Here the plain versions of that data flow (``ref.tc_left_tiles_ref`` on
the planes of ``ref.tc_left_planes_ref``, composed by
``ref.gr_matmul_tc_left_ref``) are held bit for bit against repro's
``Ring.matmul`` (XLA on the CPU) over (3, 7), (3, 4), GR(2^32, 6) and
GR(2^32, 7), at t that is not a multiple of floor(64 / D1), at depths on
either side of 32 and at ragged s, with every tile width of the ring.  The
stack's block walk is emulated from its mirror (``tc_stack_block``) and
held against ``ref.stacked_planes_ref``.  The kernels themselves run only
on the card (tests/test_torch_card.py, chip_smoke.py).
"""
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels.gr_matmul import (
    SMEM_BLOCK_BYTES,
    TC_LEFT_CONFIGS,
    TC_LEFT_DEGREES,
    TC_LEFT_DEPTH,
    TC_LIFT_TOWERS,
    tc_left_configs,
    tc_left_layout,
    tc_left_padded,
    tc_padded,
    tc_stack_block,
)
from repro_torch.kernels.ref import gr_matmul_tc_left_ref, n_limbs, stacked_planes_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

# (ring degrees, batch, t, r, s): t past a multiple of floor(64 / D) (3 at
# D = 21, 5 at 12, 10 at 6, 9 at 7); D r on either side of a multiple of
# the 32-byte stage (84 and 105 at D = 21, 96 exactly at D = 12 r = 8 and
# 108 at 9, 30 and 36 at D = 6, 28, 35 and 231 at D = 7); ragged s (S D not a
# multiple of 4 at odd s over D = 7, 21); a batch of two entries
CASES = [
    ((3, 7), None, 4, 4, 37), ((3, 7), 2, 3, 4, 9), ((3, 7), None, 7, 5, 33),
    ((3, 4), None, 6, 8, 35), ((3, 4), None, 11, 9, 16),
    ((6,), None, 13, 5, 70), ((6,), None, 11, 6, 129),
    ((7,), None, 10, 4, 65), ((7,), None, 11, 5, 40), ((7,), 2, 16, 33, 31),
]


@lru_cache(maxsize=None)
def _reference(deg, r):
    """Inputs over GR(2^32, deg) at depth r, as large in t and s as the
    cases at r take, and repro's product of them (one XLA compile each)."""
    t = max(c[2] for c in CASES if c[0] == deg and c[3] == r) + 1
    s = max(c[4] for c in CASES if c[0] == deg and c[3] == r)
    jr = jmake(2, 32, deg)
    rng = np.random.default_rng(sum(deg) + r)
    a = rng.integers(0, 2**32, size=(t, r, jr.D), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=(r, s, jr.D), dtype=np.uint64).astype(np.uint32)
    return a, b, np.asarray(jr.matmul(a, b))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_whole_t_tiles_at_the_32_byte_depth_match_reference(case):
    deg, batch, t, r, s = case
    a, b, ref = _reference(deg, r)
    # a batch: entry i takes rows i .. i + t of A, against the same B
    rows = [slice(i, i + t) for i in range(batch or 1)]
    a = np.stack([a[x] for x in rows])
    b = np.stack([b[:, :s]] * len(rows))
    ref = np.stack([ref[x, :s] for x in rows])
    if not batch:
        a, b, ref = a[0], b[0], ref[0]
    ring = make_ring(2, 32, deg)
    A, B = from_numpy(a, ring, "cpu"), from_numpy(b, ring, "cpu")
    for (bn,) in TC_LEFT_CONFIGS:  # every tile width: ragged column tiles
        np.testing.assert_array_equal(to_numpy(gr_matmul_tc_left_ref(A, B, ring, bn)), ref)


@pytest.mark.parametrize("dr,rp", [(28, 32), (32, 32), (33, 64), (84, 96), (96, 96),
                                   (231, 256), (672, 672), (14700, 14720)])
def test_depth_pads_to_the_32_byte_stage(dr, rp):
    """tc_left's depth pads to 32 bytes; tc keeps its 64-byte stage."""
    assert TC_LEFT_DEPTH == 32
    assert tc_left_padded(100, dr, 70) == (128, rp, 96)
    assert tc_padded(100, dr, 70)[1] == -(-dr // 64) * 64


def _stack_blocks(b: np.ndarray, ring, r: int, s: int):
    """The stack pre-pass's block walk in numpy (``stack_cols_kernel``):
    block (x, y) covers bytes [y KB, y KB + kb) of the depth (r, k), kb =
    min(KB, Rp - y KB): it reads the rows of r those bytes touch (zeros past
    r) at SB columns, and writes those words of its rows s of every limb
    plane.  Returns the planes and the rows of r each row of blocks read."""
    D, L = ring.D, n_limbs(ring)
    _, Rp, Sp = tc_left_padded(1, D * r, s)
    KB, SB = tc_stack_block(ring, r)
    out = np.full((1, L, Sp, Rp), 0xAB, dtype=np.uint8)  # torch.empty: nothing left unwritten
    rows_read = []
    for y in range(-(-Rp // KB)):
        k0 = y * KB
        kb = min(KB, Rp - k0)
        r0, r1 = k0 // D, -(-(k0 + kb) // D)
        rows_read.append([rr for rr in range(r0, r1) if rr < r])
        for x in range(-(-Sp // SB)):
            s0 = x * SB
            tile = np.zeros((SB, kb), dtype=np.uint64)  # [s][(r, k) - k0]
            cols = max(0, min(SB, s - s0))
            for rr in range(r0, min(r1, r)):
                for k in range(D):
                    kk = rr * D + k - k0
                    if 0 <= kk < kb:
                        tile[:cols, kk] = b[rr, s0:s0 + cols, k]
            for cc in range(min(SB, Sp - s0)):
                for l in range(L):
                    out[0, l, s0 + cc, k0:k0 + kb] = (tile[cc] >> np.uint64(8 * l)) & np.uint64(0xFF)
    return out, rows_read


@pytest.mark.parametrize("deg,r,s", [((3, 7), 4, 70), ((3, 7), 33, 9), ((3, 4), 8, 40),
                                     ((7,), 5, 33), ((16,), 3, 20), ((16,), 70, 5)], ids=str)
def test_stack_blocks_cover_the_planes_and_only_real_rows(deg, r, s):
    ring = make_ring(2, 32, deg)
    rng = np.random.default_rng(r + s)
    b = rng.integers(0, 2**32, size=(r, s, ring.D), dtype=np.uint64)
    planes, rows_read = _stack_blocks(b, ring, r, s)
    _, Rp, Sp = tc_left_padded(1, ring.D * r, s)
    want = stacked_planes_ref(from_numpy(b.astype(np.uint32), ring, "cpu"), ring, Sp, Rp).numpy()
    assert np.array_equal(planes[None] if planes.ndim == 3 else planes, want)
    # the written depth is the 32-byte stage's; where the depth fits one row
    # of blocks (every call of the 64-worker rounds), it reads every row of
    # r once and none past it
    kb, sb = tc_stack_block(ring, r)
    assert Rp == -(-ring.D * r // 32) * 32 and sb * (kb + 8) * 4 <= 48 * 1024
    if kb == Rp:
        assert rows_read == [list(range(r))]


def test_layout_keeps_a_resident_at_the_encodes():
    """tc_left_layout: at the encodes and the R = 33 decode of the 64-worker
    rounds a block takes two row tiles of M(A), both resident; at the
    (3, 7) decode (672 deep) one, resident; at a wrap check's depth one,
    streaming.  Every lifted ring at every tile width fits two stages at
    depths from 32 to a wrap check's."""
    ring = make_ring(2, 32, (3, 7))
    depth = lambda ring, r: tc_left_padded(1, ring.D * r, 1)[1]  # noqa: E731
    for r in (4, 8):  # encode a, encode b
        assert tc_left_layout(ring, (64,), depth(ring, r))[:2] == (True, True)
    assert tc_left_layout(ring, (64,), depth(ring, 32))[:2] == (False, True)
    assert tc_left_layout(make_ring(2, 32, (7,)), (64,), 256)[:2] == (True, True)
    assert tc_left_layout(ring, (64,), depth(ring, 700))[:2] == (False, False)
    for d0, d1 in TC_LIFT_TOWERS:
        for e in (8, 32):
            ring = make_ring(2, e, (d0, d1) if d0 > 1 else (d1,))
            for config in tc_left_configs(d0, d1):
                for rp in (32, 224, 672, 4096, 24576):
                    pair, resident, stages, _, smem = tc_left_layout(ring, config, rp)
                    assert 2 <= stages <= 8 and smem <= SMEM_BLOCK_BYTES, (d0, d1, e, config, rp)
                    assert resident or rp > 32
                    assert not pair or (resident and stages >= 4)


def test_tc_left_mirrors_match_the_source():
    src = (CSRC / "gr_matmul_tc_left.cu").read_text()
    body = re.search(r"#define TC_LEFT_CONFIGS\(X\)(.*?)\n", src).group(1)
    assert tuple((int(bn),) for bn in re.findall(r"X\((\d+)\)", body)) == TC_LEFT_CONFIGS
    body = re.search(r"#define TC_LEFT_DEGREES\(X\)(.*?)\n\n", src, re.S).group(1)
    degrees = tuple(int(d) for d in re.findall(r"X\((\d+)\)", body))
    assert degrees == TC_LEFT_DEGREES
    assert sorted({d0 * d1 for d0, d1 in TC_LIFT_TOWERS}) == sorted(degrees)
    const = lambda name: [int(v) for v in re.findall(rf"constexpr int {name} = (\d+);", src)]  # noqa: E731
    assert const("kDepth") == [TC_LEFT_DEPTH] and const("kRows") == [64]
    assert const("kMaxStages") == [8] and const("kMaxDeg") == [max(TC_LEFT_DEGREES)]
    assert re.findall(r"constexpr int kStackSmem = (\d+) \* 1024;", src) == ["48"]
