"""The tensor-core route's arithmetic and the route picker, on the CPU.

The ``tc`` and ``skinny`` CUDA kernels run only on the card
(tests/test_torch_card.py, marker ``cuda``).  Here their plain versions
are held against repro (JAX on the CPU), and so are the dispatch rules
around them:

* ``gr_matmul_limbs_ref`` computes the ring matmul the ``tc`` way: byte
  limbs, integer matmuls into wrapping int32 accumulators (one per conv
  plane and shift), one shift-and-add at the end, the fold.  It must equal
  repro's ``Ring.matmul`` bit for bit;
* ``pick_route`` picks a route from the ring and the shape alone;
* the Python mirrors of the kernels' instantiations match the CUDA sources.
"""
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.galois import make_ring as jmake
from repro_torch.core.galois import from_numpy, make_ring, to_numpy
from repro_torch.kernels import counters, gr_matmul_limbs_ref, gr_matmul_ref, pick_route
from repro_torch.kernels.gr_matmul import (
    MAX_D,
    SIMT_WIDE_TOWERS,
    SKINNY_CONFIGS,
    SKINNY_DEFAULT,
    SKINNY_GROUPS,
    SKINNY_MAX_R,
    SKINNY_MAX_T,
    SKINNY_SMEM_CAP,
    TC_BM,
    TC_CONFIGS,
    TC_DEPTH,
    TC_LIFT_TOWERS,
    TC_PAD,
    TOWER_CONFIGS,
    TOWER_MAX_TR,
    gr_matmul_skinny,
    gr_matmul_tc,
    gr_matmul_tower,
    simt_instantiated,
    skinny_cols,
    tc_configs,
    tc_instantiated,
    tc_limbs,
    tc_padded,
    tc_shape,
    tc_smem_bytes,
    tc_tile,
    tower_configs,
    tower_smem_bytes,
)
from repro_torch.kernels.ref import limb_planes_ref, n_limbs, tc_view

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# the seven rings of tests/test_torch_kernels.py, by tower degrees
DEGREES = [(), (3,), (4,), (5,), (2, 3), (16,), (3, 5)]


def _inputs(spec, shape, seed):
    """Uniform ring elements made with numpy: every coefficient below 2^e."""
    jr = jmake(*spec)
    t, r, s = shape
    rng = np.random.default_rng(seed)
    draw = lambda *dims: rng.integers(0, 2**spec[1], size=dims + (jr.D,), dtype=np.uint64).astype(np.uint32)
    return jr, draw(t, r), draw(r, s)


@lru_cache(maxsize=None)
def _reference(deg):
    """Inputs over GR(2^32, deg) and repro's product of them (one XLA
    compile per ring: the cost of this file)."""
    jr, a, b = _inputs((2, 32, deg), (5, 37, 6), seed=len(deg))
    return jr, a, b, np.asarray(jr.matmul(a, b))


@pytest.mark.parametrize("e", [8, 16, 31, 32])
@pytest.mark.parametrize("deg", DEGREES, ids=str)
def test_limbs_ref_matches_reference(deg, e):
    # repro's GR(2^e, deg) has GR(2^32, deg)'s tables mod 2^e, so reducing
    # mod 2^e maps one ring onto the other: the product of the reduced
    # inputs over GR(2^e) is repro's GR(2^32) product reduced
    jr32, a, b, ref = _reference(deg)
    jr = jmake(2, e, deg)
    assert np.array_equal(jr.CONVPOS, jr32.CONVPOS)
    assert np.array_equal(jr.FOLD % 2**e, jr32.FOLD % 2**e)
    mask = np.uint32(2**e - 1)
    ring = make_ring(2, e, deg)
    A, B = from_numpy(a & mask, ring, "cpu"), from_numpy(b & mask, ring, "cpu")
    got = gr_matmul_limbs_ref(A, B, ring)
    np.testing.assert_array_equal(to_numpy(got), ref & mask)


def test_limbs_ref_batched_and_extreme_values():
    # a batch of (A, B) and (A with rows reversed, B with columns reversed),
    # whose products are repro's product and that product reversed both ways
    _, a, b, ref = _reference((3,))
    ring = make_ring(2, 32, (3,))
    A = from_numpy(np.stack([a, a[::-1]]), ring, "cpu")
    B = from_numpy(np.stack([b, b[:, ::-1]]), ring, "cpu")
    got = to_numpy(gr_matmul_limbs_ref(A, B, ring))
    np.testing.assert_array_equal(got, np.stack([ref, ref[::-1, ::-1]]))
    # every limb 0xFF: the largest chains, exact mod 2^32
    A = torch.full((3, 300, ring.D), -1, dtype=torch.int32)
    B = torch.full((300, 2, ring.D), -1, dtype=torch.int32)
    assert torch.equal(gr_matmul_limbs_ref(A, B, ring), gr_matmul_ref(A, B, ring))


@pytest.mark.parametrize("deg,r", [((3,), 2048), ((3,), 2816), ((4,), 2112), ((4,), 4160)])
def test_limbs_ref_wraps_at_the_largest_chain(deg, r):
    # every limb 0xFF: accumulator (c, s) chains count(c) * (s + 1) byte
    # products of 255^2 per element of r, 12 at D = 3 and 16 at D = 4 for
    # the middle conv plane and s = 3.  At r = 2048 (D = 3) no chain passes
    # 2^31; past 2752 (D = 3) or 2064 (D = 4) one does, and at 4160 (D = 4)
    # one passes 2^32: wrapping mod 2^32 keeps every shift-add exact
    ring = make_ring(2, 32, deg)
    chain = r * (ring.D * 4) * 255 ** 2 if deg == (4,) else r * 12 * 255 ** 2
    assert (chain >= 2 ** 31) == (r > 2048)
    A = torch.full((2, r, ring.D), -1, dtype=torch.int32)
    B = torch.full((r, 3, ring.D), -1, dtype=torch.int32)
    assert torch.equal(gr_matmul_limbs_ref(A, B, ring), gr_matmul_ref(A, B, ring))


@pytest.mark.parametrize("transpose", [False, True])
def test_limb_planes_layout(transpose):
    ring = make_ring(2, 20, (3,))  # L = 3
    X = ring.random(np.random.default_rng(2), (2, 5, 7), device="cpu")  # (b, x, y, D)
    P = limb_planes_ref(X, ring, 32, 64, transpose=transpose)
    assert P.dtype == torch.uint8 and P.shape == (2, ring.D, n_limbs(ring), 32, 64)
    want = X.movedim(-1, -3)  # (b, D, x, y)
    if transpose:
        want = want.transpose(-1, -2)
    rows, cols = want.shape[-2:]
    words = sum(P[:, :, l].to(torch.int64) << (8 * l) for l in range(n_limbs(ring)))
    assert torch.equal(words[..., :rows, :cols], want.to(torch.int64) & 0xFFFFFFFF)
    assert not words[..., rows:, :].any() and not words[..., :, cols:].any()


def test_tc_padding_follows_the_tile():
    # T and S to the pre-pass's 32 (TMA zero-fills a tile past them), R to
    # the 64-byte swizzled box depth; no instantiation changes the padding
    assert (TC_PAD, TC_DEPTH, TC_BM) == (32, 64, 64)
    assert tc_padded(1024, 2048, 1024) == (1024, 2048, 1024)
    assert tc_padded(70, 300, 97) == (96, 320, 128)
    assert tc_padded(33, 1, 65) == (64, 64, 96)
    assert all(x % m == 0 for x, m in zip(tc_padded(33, 1, 65), (TC_PAD, TC_DEPTH, TC_PAD)))


@pytest.mark.parametrize("tower", sorted(TC_CONFIGS), ids=str)
def test_tc_instantiations_fit_the_block(tower):
    # every instantiation: a wgmma width (N = 16, 24, 32, 48, ...), its
    # stages within 227 KB at every L, and the reckoning of Tc::kSmem:
    # 1 KB of alignment slack, the ring (each stage rounded up to 1 KB; the
    # epilogue's exchange reuses it) and two mbarriers a stage
    for e in (8, 16, 24, 32):
        ring = make_ring(2, e, (tower[0],) if tower[0] > 1 else ())
        planes = ring.D * n_limbs(ring)
        for bn, stages in TC_CONFIGS[tower]:
            assert bn % 16 == 0 or bn == 24
            assert tc_tile((bn, stages)) == (TC_BM, bn)
            stage = -(-planes * (TC_BM + bn) * TC_DEPTH // 1024) * 1024
            want = 1024 + max(stages * stage, ring.D * bn * 256) + 16 * stages
            assert tc_smem_bytes(ring, (bn, stages)) == want <= 227 * 1024
    # the tightest: GR(2^32, 3) at 64 x 32 with three stages
    assert tc_smem_bytes(make_ring(2, 32, (3,)), (32, 3)) == 222256


# (ring degrees, t, r, s, route): the main path's calls (batch_ep_rmfe at
# 2048^3: phi, encode a/b, workers, decode, psi) and the edges of the rule
ROUTE_CASES = [
    ((), 2, 2, 4194304, "skinny"),
    ((3,), 8, 2, 2097152, "skinny"),
    ((3,), 1024, 2048, 1024, "tc"),
    ((3,), 4, 4, 1048576, "skinny"),
    ((), 2, 3, 4194304, "skinny"),
    ((3,), 16, 16, 100, "skinny"),
    ((3,), 17, 2, 1048576, "skinny"),   # t > 16: the widened skinny takes t <= 64
    ((3,), 8, 17, 1048576, "skinny"),   # r > 16: and r <= 32
    ((3,), 8, 33, 1048576, "simt"),     # r > 32 and t < 64
    ((3,), 16, 0, 100, "simt"),         # nothing to reduce: not the skinny kernel
    ((3,), 64, 2048, 64, "tc"),
    ((3,), 63, 2048, 1024, "simt"),
    ((3,), 1024, 2048, 63, "simt"),
    ((5,), 1024, 2048, 1024, "tc"),     # D = 5: lifted onto Z_2^32 as the tower (1, 5)
    ((3, 5), 4, 4, 1048576, "tower"),   # no skinny instantiation for (3, 5)
    ((17,), 4, 4, 1048576, "plain"),    # D > MAX_D: outside the envelope
    # D = 21: the worker product lifted onto GR(2^32, 3), the encodes and
    # the decode of ElasticStream's step on the tower kernel
    ((3, 7), 512, 1024, 256, "tc"),
    ((3, 7), 8, 2, 131072, "tower"),
    ((3, 7), 8, 4, 262144, "tower"),
    ((3, 7), 8, 8, 131072, "tower"),
    ((3, 7), 12, 9, 1000, "tower"),     # t r = 108: the lifted A still fits a block
    ((3, 7), 16, 16, 100, "tc_left"),   # t r = 256: it does not; A is lifted instead
    ((3, 7), 32, 20, 4096, "tc_left"),  # t < 64 and r > 16
    ((3, 7), 64, 1024, 10, "tc"),       # D1 s = 70 >= 64
    ((3, 7), 64, 1024, 9, "simt"),      # D1 s = 63
    ((2, 3), 1024, 2048, 1024, "tc"),   # lifted onto GR(2^32, 2)
    ((3, 4), 1024, 2048, 1024, "tc"),   # lifted onto GR(2^32, 3)
    ((5, 3), 1024, 2048, 1024, "simt"),  # inner degree 5: no tc instantiation
    ((5, 3), 4, 4, 1048576, "tower"),
]


@pytest.mark.parametrize("deg,t,r,s,route", ROUTE_CASES, ids=str)
def test_pick_route(deg, t, r, s, route):
    assert pick_route(make_ring(2, 32, deg), t, r, s) == route


def test_pick_route_outside_envelope():
    assert pick_route(make_ring(3, 2, (2,)), 4, 4, 100) == "plain"
    assert make_ring(2, 32, (17,)).D > MAX_D


def _towers(source: str, macro: str):
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", (CSRC / source).read_text(), re.S).group(1)
    return sorted((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body))


def _configs(source: str, macro: str):
    body = re.search(rf"#define {macro}\(X\)(.*?)\n\n", (CSRC / source).read_text(), re.S).group(1)
    return [tuple(int(x) for x in c if x)
            for c in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)(?:, (\d+))?\)", body)]


def test_instantiation_mirrors_match_the_sources():
    towers = _towers("gr_matmul.cu", "GR_TOWERS")
    assert len(towers) == 27
    assert [t for t in towers if t[0] * t[1] > MAX_D] == list(SIMT_WIDE_TOWERS)
    assert all(simt_instantiated(*t) for t in towers) and not simt_instantiated(17, 1)
    # the tc instantiations (tower, tile width, stages), default first, and
    # the two-level towers lifted onto their inner ring's; the skinny ones:
    # every tower's default plus SKINNY_EXTRA
    tc = _configs("gr_matmul_tc.cu", "TC_CONFIGS")
    assert sorted({c[:2] for c in tc}) == sorted(TC_CONFIGS)
    assert _towers("gr_matmul_tc.cu", "TC_LIFT_TOWERS") == sorted(TC_LIFT_TOWERS)
    # a single-level ring past the kernel's own D <= 4 is lifted as (1, D):
    # every simt tower but (5, 2), (5, 3) and (7, 2) has a tc route
    assert sorted({tc_view(*t) for t in towers if tc_instantiated(*t)}) == sorted(
        {*TC_CONFIGS, *TC_LIFT_TOWERS})
    assert [t for t in towers if not tc_instantiated(*t)] == [(5, 2), (5, 3), (7, 2)]
    assert all(t[1] > 1 and (t[0], 1) in TC_CONFIGS for t in TC_LIFT_TOWERS)
    assert [t for t in TC_LIFT_TOWERS if t[0] == 1] == [(1, d) for d in range(5, MAX_D + 1)]
    assert {t: tuple(c[2:] for c in tc if c[:2] == t) for t in TC_CONFIGS} == TC_CONFIGS
    # the tower kernel: every simt tower without a skinny instantiation
    tower = _configs("gr_matmul_tower.cu", "TOWER_CONFIGS")
    assert sorted({c[:2] for c in tower}) == [t for t in towers if not skinny_cols(*t)]
    assert {t: tuple(c[2:] for c in tower if c[:2] == t) for t in TOWER_CONFIGS} == TOWER_CONFIGS
    assert _towers("gr_matmul_skinny.cu", "SKINNY_TOWERS") == [t for t in towers if skinny_cols(*t)]
    extra = _configs("gr_matmul_skinny.cu", "SKINNY_EXTRA")
    assert {t: (SKINNY_DEFAULT,) + tuple(c[2:] for c in extra if c[:2] == t)
            for t in SKINNY_CONFIGS} == SKINNY_CONFIGS
    assert SKINNY_DEFAULT == (128, 1) and all(skinny_cols(*t) for t in SKINNY_CONFIGS)
    src = (CSRC / "gr_matmul_tc.cu").read_text()
    assert [int(v) for v in re.findall(r"constexpr int KS = (\d+);", src)] == [TC_DEPTH]
    assert [int(v) for v in re.findall(r"constexpr int kBM = (\d+);", src)] == [TC_BM]
    # the lift's widest outer level, and the bandwidth kernels' shape limits
    assert [int(v) for v in re.findall(r"constexpr int kMaxD1 = (\d+);", src)] == [
        max(t[1] for t in TC_LIFT_TOWERS)]
    const = lambda source, name: [int(v) for v in re.findall(  # noqa: E731
        rf"constexpr int {name} = (\d+)(?: \* 1024)?;", (CSRC / source).read_text())]
    assert const("gr_matmul_skinny.cu", "kMaxT") == [SKINNY_MAX_T]
    assert const("gr_matmul_skinny.cu", "kMaxR") == [SKINNY_MAX_R]
    assert [x * 1024 for x in const("gr_matmul_skinny.cu", "kSmemCap")] == [SKINNY_SMEM_CAP]
    assert const("gr_matmul_skinny.cu", "kGroups") == [SKINNY_GROUPS]
    assert const("gr_matmul_tower.cu", "kMaxT") == const("gr_matmul_tower.cu", "kMaxR") == [
        TOWER_MAX_TR]


def test_route_wrappers_take_cuda_tensors_only():
    ring = make_ring(2, 32, (3,))
    A = ring.random(np.random.default_rng(0), (4, 4), device="cpu")
    counters.reset()
    for wrapper in (gr_matmul_tc, gr_matmul_skinny, gr_matmul_tower, tc_limbs):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(A, A, ring)
    assert counters.launches == 0 and not any(counters.launches_by_route.values())
    counters.count("tc")
    counters.count("limbs")
    assert counters.launches == 1 and counters.launches_by_route["limbs"] == 1
    counters.reset()


def test_counters_and_layout_cache_are_safe_under_concurrent_callers():
    """The elastic backend's worker threads launch ring matmuls at once: no
    count may be lost, and every caller gets the one cached FOLD array."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.gr_matmul import _check_layout

    ring = make_ring(2, 32, (4,))
    counters.reset()

    def work(_):
        for _ in range(2000):
            counters.count("tc")
            counters.count("limbs")
        return _check_layout(ring)

    with ThreadPoolExecutor(8) as pool:
        layouts = list(pool.map(work, range(16)))
    assert counters.launches_by_route["tc"] == counters.launches == 16 * 2000
    assert counters.launches_by_route["limbs"] == 16 * 2000
    assert all(x is layouts[0] for x in layouts)
    counters.reset()


@pytest.mark.parametrize("deg", sorted(TC_LIFT_TOWERS), ids=str)
def test_lifted_towers_run_their_inner_rings_tc_kernel(deg):
    # the main kernel's instantiation, shared memory and padding are the
    # inner ring's, at the lifted depth and width (a tower (1, D) is the
    # single-level GR(2^32, D) over Z_2^32)
    ring = make_ring(2, 32, deg if deg[0] > 1 else deg[1:])
    inner = make_ring(2, 32, deg[:1] if deg[0] > 1 else ())
    tower = deg if deg[0] > 1 else (deg[1], 1)
    assert tc_instantiated(*tower) and tc_configs(*tower) == TC_CONFIGS[(deg[0], 1)]
    for config in tc_configs(*tower):
        assert tc_smem_bytes(ring, config) == tc_smem_bytes(inner, config)
    assert tc_shape(ring, 512, 1024, 256) == (deg[0], 512, deg[1] * 1024, deg[1] * 256)


def test_tower_kernel_fits_its_instantiations():
    # the lifted A (t r D x DP words, DP = D rounded up to 4), FOLD and A;
    # every instantiation within the register file
    from repro_torch.kernels import autotune as at

    ring = make_ring(2, 32, (3, 7))
    assert tower_smem_bytes(ring, 8, 8) == 4 * (64 * 21 * 24 + 65 * 21 + 64 * 21) == 139860
    assert tower_smem_bytes(ring, 12, 9) <= 227 * 1024 < tower_smem_bytes(ring, 16, 7)
    for tower, configs in TOWER_CONFIGS.items():
        r = make_ring(2, 32, tower if tower[1] > 1 else tower[:1])
        assert tower_configs(*tower) == configs
        assert all(at.fits_budget("tower", r, c) for c in configs), tower
