"""The ``simt`` route's arithmetic as its kernels run it, on the CPU.

The route's thin kernel (``csrc/gr_matmul.cu``, t <= 64 over GR(2^e,
D <= 4)) lifts A to its multiplication matrices M(A) a stage of 32 rows of
r at a time (x^(k+1) a = x (x^k a)), splits M(A) and B into bytes, keeps
one wrapping s32 accumulator a limb shift, splits R into runs of whole
stages where the grid is small, adds the runs' parts into C wrapping mod
2^32 and masks once at the end; its tile kernel keeps the conv accumulators
of every other call.  The plain version of both, ``ref.gr_matmul_simt_ref``,
is held here bit for bit against repro's ``gr_matmul_planar`` (the Pallas
kernel in interpret mode, as tests/test_kernels.py runs it) over the thin
kernel's rings and GR(2^16, 5), repro's ``Ring.matmul`` (XLA) over the
others ((5, 2), GR(2^32, 5) and the (3, 7) tower, which the Pallas kernel
does not take) and the port's ``ref.gr_matmul_ref``, at every R split the
grid helper can choose; the grid helper and tile mirrors are held against
the kernel source.  The kernels themselves run only on the card
(tests/test_torch_card.py, chip_smoke.py).
"""
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro.kernels.gr_matmul import gr_matmul_planar as jax_planar
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import gr_matmul_ref, gr_matmul_simt_ref
from repro_torch.kernels.gr_matmul import (
    SIMT_THIN_CONFIGS,
    SIMT_THIN_MAX_D,
    SIMT_THIN_MAX_T,
    kernel_tile,
    simt_grid,
    simt_thin,
)
from repro_torch.kernels.ref import thin_lift_ref, mult_matrices_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# (e, tower degrees): the thin kernel's rings and the tile kernel's, at
# e = 32 and 31 (the mask after a split sum), and GR(2^16, 5)
RINGS = [(e, deg) for deg in ((), (3,), (4,), (5,), (5, 2), (3, 7)) for e in (32, 31)]
RINGS.append((16, (5,)))
TS = (1, 4, 16, 48, 63)
R, S = 70, 9  # r past two 32-row stages (three runs), ragged s
SPLIT_R = 250  # eight stages, the last one ragged: every split count 1..8


def _draw(rng, e, D, *dims):
    return rng.integers(0, 2**e, size=dims + (D,), dtype=np.uint64).astype(np.uint32)


@lru_cache(maxsize=None)
def _reference(e, deg, r=R):
    """Inputs over GR(2^e, deg) at depth r with max(TS) rows, and repro's
    product: the Pallas kernel in interpret mode over the thin kernel's
    rings and GR(2^16, 5) at depth R, else XLA (the Pallas kernel takes no
    D > 16, and interprets D = 10 for seconds)."""
    jr = jmake(2, e, deg)
    rng = np.random.default_rng(e + len(deg) + sum(deg) + r)
    a, b = _draw(rng, e, jr.D, max(TS), r), _draw(rng, e, jr.D, r, S)
    if (jr.D <= SIMT_THIN_MAX_D or e == 16) and r == R:
        ref = np.moveaxis(np.asarray(jax_planar(np.moveaxis(a, -1, 0), np.moveaxis(b, -1, 0), jr,
                                                interpret=True)), 0, -1)
    else:
        ref = np.asarray(jr.matmul(a, b))
    return a, b, ref


@pytest.mark.parametrize("ring_spec", RINGS, ids=str)
def test_simt_ref_matches_the_reference_at_every_t(ring_spec):
    e, deg = ring_spec
    a, b, ref = _reference(e, deg)
    ring = make_ring(2, e, deg)
    B = from_numpy(b, ring, "cpu")
    for t in TS:
        A = from_numpy(a[:t], ring, "cpu")
        got = gr_matmul_simt_ref(A, B, ring)
        np.testing.assert_array_equal(to_numpy(got), ref[:t], err_msg=f"t={t}")
        assert torch.equal(got, gr_matmul_ref(A, B, ring))


@pytest.mark.parametrize("ring_spec", [(e, d) for e, d in RINGS if len(d) < 2 and sum(d) <= 4],
                         ids=str)
def test_every_r_split_sums_wrapping_and_masks_once(ring_spec):
    # the thin kernel's rings at eight stages: each split count the grid
    # helper may choose gives repro's product (batch of two, t = 16 and 48)
    e, deg = ring_spec
    a, b, ref = _reference(e, deg, SPLIT_R)
    ring = make_ring(2, e, deg)
    for t in (16, 48):
        A = from_numpy(np.stack([a[:t], a[1:t + 1]]), ring, "cpu")
        B = from_numpy(np.stack([b, b]), ring, "cpu")
        want = np.stack([ref[:t], ref[1:t + 1]])
        for splits in range(1, 9):
            got = gr_matmul_simt_ref(A, B, ring, splits=splits)
            np.testing.assert_array_equal(to_numpy(got), want, err_msg=f"t={t} splits={splits}")


def test_split_parts_wrap_past_2_32_before_the_mask():
    # all-ones operands over GR(2^31, 3): each run's part passes 2^31, so
    # the runs' sum carries into bit 31 and only the final mask drops it
    ring = make_ring(2, 31, (3,))
    A = torch.full((20, SPLIT_R, 3), 2**31 - 1, dtype=torch.int32)
    B = torch.full((SPLIT_R, 5, 3), 2**31 - 1, dtype=torch.int32)
    want = gr_matmul_ref(A, B, ring)
    for splits in (1, 3, 8):
        assert torch.equal(gr_matmul_simt_ref(A, B, ring, splits=splits), want)


@pytest.mark.parametrize("deg", [(), (2,), (3,), (4,)], ids=str)
def test_lift_by_the_modulus_is_the_multiplication_matrix(deg):
    # x^(k+1) a = x (x^k a) with FOLD's row D as x^D gives M(a)[k, m]
    ring = make_ring(2, 32, deg)
    A = ring.random(np.random.default_rng(1), (5, 7), device="cpu")
    assert torch.equal(thin_lift_ref(A, ring), mult_matrices_ref(A, ring))


def _source_constants():
    text = (CSRC / "gr_matmul.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+)", text.split("namespace thin {")[1]))
    configs = re.search(r"#define THIN_CONFIGS\(X\)(.*?)\n\n", text, re.S).group(1)
    return consts, tuple(tuple(map(int, m))
                         for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", configs))


def test_thin_mirrors_match_the_source():
    consts, configs = _source_constants()
    assert configs == SIMT_THIN_CONFIGS
    assert (int(consts["kMaxD"]), int(consts["kMaxT"])) == (SIMT_THIN_MAX_D, SIMT_THIN_MAX_T)
    assert (int(consts["kBK"]), int(consts["kStages"]), int(consts["kRows"])) == (32, 3, 64)
    assert (int(consts["kMaxSplits"]), int(consts["kBlocksPerSm"])) == (8, 2)
    for D in range(1, SIMT_THIN_MAX_D + 1):
        ring = make_ring(2, 32, (D,) if D > 1 else ())
        for t in range(1, SIMT_THIN_MAX_T + 1):
            thin, _, chunks, _, _, rc, nn, wm, wn, smem = simt_grid(ring, 1, t, 4608, 1152, 132)
            assert thin and (D, rc, nn, wm, wn) in SIMT_THIN_CONFIGS and wm * wn in (4, 8)
            # two blocks an SM: 113 KB each; 128 registers at two warp rows
            assert smem <= 113 * 1024 and rc * nn <= (4 if wm == 1 else 2)
            t_blk, bn, bk = kernel_tile(ring, t)
            assert t_blk == min(t, 64 // D) and chunks == -(-t // t_blk) and bk == 32
            assert bn == 8 * wn * nn and bn * D <= 128
            assert -(-D * t_blk // 16) <= rc * wm  # the block's m16 tiles cover its rows


def test_grid_splits_r_where_the_grid_is_small():
    gr4, gr3 = make_ring(2, 32, (4,)), make_ring(2, 32, (3,))
    # CodedQuantMatmul's worker products at 8 tokens over GR(2^32, 4): the
    # up-projection fills 8.7 waves unsplit, the down-projection's 576
    # blocks are split 3 ways (93% of the last wave)
    assert simt_grid(gr4, 16, 4, 1152, 4608, 132)[:5] == (1, 2304, 1, 144, 1)
    assert simt_grid(gr4, 16, 4, 4608, 1152, 132)[:5] == (1, 1728, 1, 36, 3)
    # ep's 48-row worker blocks at 96^3: three t chunks (21, 21, 6), one
    # s tile, eight entries, R split into its three stages
    assert simt_grid(gr3, 8, 48, 96, 32, 132)[:5] == (1, 72, 3, 1, 3)
    # no split past the stages, nor past 8
    assert simt_grid(gr3, 1, 4, 20, 8, 132)[4] == 1
    assert simt_grid(gr3, 1, 4, 32 * 40, 8, 132)[4] == 8
    # the tile kernel: past 64 rows, and every ring outside the thin kernel
    assert not simt_thin(gr3, 65) and simt_thin(gr3, 64)
    assert not simt_thin(make_ring(2, 32, (5,)), 1)
    assert not simt_thin(make_ring(2, 32, (2, 3)), 1)
    assert simt_grid(gr3, 8, 1024, 2048, 1024, 132) == (0, 8 * 16 * 16, 16, 16, 1, 0, 0, 0, 0, 0)
    assert kernel_tile(gr3, 65) == kernel_tile(gr3) == (64, 64, 16)
