"""Hopper kernel wrappers: the five routes of the Galois-ring matmul over
GR(2^e, D).

All five replace the Pallas TPU kernel
``src/repro/kernels/gr_matmul.py:_kernel`` (launched by
``gr_matmul_planar``); each is hand-written CUDA C++ under ``csrc/`` whose
header notes its design and what bounds it:

* ``simt`` (``csrc/gr_matmul.cu``): interleaved layout, every tower with
  D <= 16 and the towers of ``SIMT_WIDE_TOWERS``, every shape, in two
  kernels (``simt_thin``): up to ``SIMT_THIN_MAX_T`` = 64 rows over
  GR(2^e, D <= 4), a thin kernel on the int8 tensor cores (``mma.sync``
  m16n8k32 u8 x u8 -> s32 on A's multiplication matrices M(A) over Z_2^e,
  lifted in the kernel a stage at a time, B read once as it lies through
  a ring of ``cp.async`` stages, R split where the grid is small:
  ``simt_grid``, ``ref.gr_matmul_simt_ref``); every other call on a tile
  kernel of uint32 multiply-adds on the CUDA cores.
* ``tc`` (``csrc/gr_matmul_tc.cu``): interleaved layout, a limb pre-pass
  (counted as ``limbs``) into u8 planes, then a warp-specialised kernel:
  TMA loads into a ring of stages, ``wgmma`` u8 x u8 -> s32 on the int8
  tensor cores; single-level towers with D <= 4 as they are, and the
  lifted towers of ``TC_LIFT_TOWERS`` as products over their inner ring
  (``ref.tc_view``): every single-level GR(2^e, D) with 5 <= D <= 16 as the
  tower (1, D) over Z_2^e, and the two-level towers (2, 3), (2, 5), (2, 7),
  (3, 2), (3, 4), (3, 5), (4, 3) and the (3, 7) tower.  A's limb pre-pass
  reads A as it lies, and a lift pre-pass (counted as ``lift``) writes
  the limb planes of B's outer-level lift M(B) (``ref.lift_b_ref``).
* ``tc_left`` (``csrc/gr_matmul_tc_left.cu``): a lifted ring's calls
  whose left operand is small (``ref.gr_matmul_tc_left_ref``), over
  Z_2^e: a lift pre-pass (counted as ``lift``) writes the limb planes of
  A's multiplication matrices M(A) (D t x D r), a stack pre-pass (counted
  as ``stack``) writes B's as it lies, K index (r, k), both padded in K to
  32 bytes (``tc_left_padded``), and a persistent ``wgmma`` kernel of its
  own walks row tiles of whole t, writing product row (t, m) to C[t, s, m]
  as one contiguous run per t (``TC_LEFT_CONFIGS``: tile widths;
  ``tc_left_layout``: its shared memory).
* ``skinny`` (``csrc/gr_matmul_skinny.cu``): interleaved layout, a
  bandwidth kernel for T <= 64, R <= 32 over the towers with K * CPT <= 64
  (``skinny_cols``): single-level D <= 8 and the even D to 16, and (2, 3),
  (2, 5), (3, 2), (3, 4), (4, 3), (5, 2); A and a slab of B live in
  shared memory, whose need (``skinny_smem_bytes``) decides where it
  runs.
* ``tower`` (``csrc/gr_matmul_tower.cu``): interleaved layout, T, R <= 16
  over the towers ``skinny`` has no instantiation for (``TOWER_CONFIGS``:
  the (3, 7) tower, (3, 5), ...), A lifted in shared memory to its
  multiplication matrices (``ref.gr_matmul_tower_ref``), within
  ``SMEM_BLOCK_BYTES`` (``tower_smem_bytes``).

``tc``, ``skinny`` and ``tower`` come in a few instantiations per tower
(``TC_CONFIGS``: tile width and stages; ``SKINNY_CONFIGS``: threads per
block and a multiple of the columns per thread; ``TOWER_CONFIGS``: threads,
rows and columns a thread), the default first; the wrappers take a
``config`` and launch exactly that one (``None``: the default).
``kernels.autotune`` times them and ``ops.pick_blocks`` picks.

This module validates the operands, launches on PyTorch's current stream
through ctypes, and counts launches.  Which route a ring matmul takes is
decided in ``ops.pick_route``, whose docstring states every route's
envelope.

Envelope: p = 2, e <= 32, D <= MAX_D = 16 (the reference's), widened by
the (3, 7) tower (D = 21), the ring ``batch_ep_rmfe`` takes at n = 8 over
Z_2^32, which ``ElasticStream`` plans for a group of eight products (the
reference leaves it to XLA): ``simt`` takes it at every shape, ``tc`` (by
the lift) and ``tower`` at theirs.  Towers of at most two coprime levels
cover every D <= 16.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .build import load_library
from .ref import TC_LEFT_DEPTH, n_limbs, outer_reduction, tc_left_padded, tc_view

__all__ = [
    "MAX_D",
    "PREPASSES",
    "ROUTES",
    "SKINNY_MAX_T",
    "SKINNY_MAX_R",
    "SIMT_THIN_CONFIGS",
    "SIMT_THIN_MAX_D",
    "SIMT_THIN_MAX_T",
    "SIMT_WIDE_TOWERS",
    "SKINNY_CONFIGS",
    "SKINNY_GROUPS",
    "SKINNY_SMEM_CAP",
    "SMEM_BLOCK_BYTES",
    "TC_CONFIGS",
    "TC_BM",
    "TC_DEPTH",
    "TC_LEFT_CONFIGS",
    "TC_LEFT_DEGREES",
    "TC_LEFT_DEPTH",
    "TC_LEFT_MAX_T",
    "TC_LIFT_TOWERS",
    "TC_PAD",
    "TOWER_CONFIGS",
    "TOWER_MAX_TR",
    "counters",
    "gr_matmul_planar",
    "gr_matmul_simt",
    "gr_matmul_skinny",
    "gr_matmul_tc",
    "gr_matmul_tc_left",
    "gr_matmul_tower",
    "kernel_tile",
    "simt_grid",
    "simt_instantiated",
    "simt_thin",
    "skinny_cols",
    "skinny_configs",
    "skinny_block",
    "skinny_smem_bytes",
    "tc_configs",
    "tc_instantiated",
    "tc_left_configs",
    "tc_left_default",
    "tc_left_layout",
    "tc_left_grid",
    "tc_left_lift",
    "tc_left_limbs",
    "tc_left_main",
    "tc_left_padded",
    "tc_lift",
    "tc_limbs",
    "tc_padded",
    "tc_shape",
    "tc_smem_bytes",
    "tc_stack",
    "tc_stack_block",
    "tc_tile",
    "tower_configs",
    "tower_shape",
    "tower_smem_bytes",
]

MAX_D = 16
# two-level towers with D > MAX_D that the simt kernel is instantiated for
# (mirrors the tail of GR_TOWERS in csrc/gr_matmul.cu)
SIMT_WIDE_TOWERS = ((3, 7),)
ROUTES = ("simt", "tc", "skinny", "tower", "tc_left")
# simt's thin kernel takes single-level rings with D <= SIMT_THIN_MAX_D up
# to SIMT_THIN_MAX_T rows (mirror kMaxD and kMaxT in csrc/gr_matmul.cu);
# its (D, rc, nn, wm, wn) instantiations: wm x wn warps of rc m16 tiles x
# nn n8 tiles (mirrors THIN_CONFIGS there)
SIMT_THIN_MAX_D, SIMT_THIN_MAX_T = 4, 64
SIMT_THIN_CONFIGS = tuple((d, *c) for d in range(1, SIMT_THIN_MAX_D + 1)
                          for c in ((1, {1: 4, 2: 2}.get(d, 1), 1, 4),
                                    (2, {1: 2, 2: 2}.get(d, 1), 1, 4), (2, 1, 2, 4)))
# the thin kernel's stage depth (rows of r), ring of stages, rows of M(A) a
# block, words past each B row, R splits at most, blocks an SM (mirror
# kBK, kStages, kRows, kPad, kMaxSplits, kBlocksPerSm)
_THIN_BK, _THIN_STAGES, _THIN_ROWS, _THIN_PAD, _THIN_SPLITS, _THIN_PER_SM = 32, 3, 64, 8, 8, 2
# the tc routes' pre-passes: A's (and a single-level B's) limb planes, the
# limb planes of a lifted tower's M(B) (tc), B's limb planes stacked along
# (r, k) (tc_left), and the limb planes of M(A) (tc_left)
PREPASSES = ("limbs", "lift", "stack", "left_lift")
# the skinny kernel keeps A (T x R x D words) in shared memory: the encodes
# (N x k, k <= 8) and decodes (R x R) of up to N = 64 workers
SKINNY_MAX_T, SKINNY_MAX_R = 64, 32
# shared memory a skinny block keeps under where it can (two blocks an SM):
# past it a block halves its threads, or a widened call splits its rows
# (SKINNY_GROUPS); a block may ask for up to SMEM_BLOCK_BYTES (mirrors
# kSmemCap in csrc/gr_matmul_skinny.cu)
SKINNY_SMEM_CAP = 100 * 1024
# row groups of a widened skinny call whose slab of B would not fit otherwise
# (mirrors kGroups in csrc/gr_matmul_skinny.cu)
SKINNY_GROUPS = 4
# the tower kernel keeps A lifted to its multiplication matrices in shared
# memory: t, r <= 16 (mirrors kMaxT in csrc/gr_matmul_tower.cu)
TOWER_MAX_TR = 16
# (bn, stages) instantiations of the tc kernel per tower, the default
# first: a 64 x bn block tile (two consumer warpgroups, each with half of
# the tile's (conv plane, shift) accumulators) and a ring of `stages` TMA
# stages; each is built for L = 1..4 (mirrors TC_CONFIGS in
# csrc/gr_matmul_tc.cu)
TC_CONFIGS = {
    (1, 1): ((128, 4), (64, 4)),
    (2, 1): ((64, 3), (48, 3), (32, 4)),
    (3, 1): ((32, 3), (32, 2), (24, 3)),
    (4, 1): ((24, 2), (16, 2)),
}
# towers (d0, d1) the tc route takes through the lift pre-pass, at the
# instantiations of their inner ring (d0, 1): every single-level ring with
# 5 <= D <= 16 as (1, D) (``ref.tc_view``), the two-level towers with an
# inner degree <= 4 that the planner's RMFE chains and the kernel checks
# reach, and the (3, 7) tower of ElasticStream; (5, 2), (5, 3) and (7, 2)
# have no inner instantiation (mirrors TC_LIFT_TOWERS in
# csrc/gr_matmul_tc.cu)
TC_LIFT_TOWERS = tuple((1, d) for d in range(5, MAX_D + 1)) + (
    (2, 3), (2, 5), (2, 7), (3, 2), (3, 4), (3, 5), (3, 7), (4, 3))
# KS: bytes of R per stage (the TMA box depth, one 64-byte swizzle row),
# the multiple the limb planes' R is padded to
TC_DEPTH = 64
# rows of every tc block tile (one wgmma M) and the padding of the limb
# planes' T and S (the pre-pass works in 32 x 32 tiles; TMA zero-fills the
# rest of a box)
TC_BM = 64
TC_PAD = 32
# dynamic shared memory one block may ask for on sm_90 (227 KB)
SMEM_BLOCK_BYTES = 227 * 1024
# tile widths (bn,) of the tc_left kernel: a consumer warpgroup's 64 x bn
# tile over Z_2^e with all L of its accumulators (bn / 2 registers each);
# each is built for L = 1..4 (mirrors TC_LEFT_CONFIGS in
# csrc/gr_matmul_tc_left.cu).  A call's default is ``tc_left_default``'s
TC_LEFT_CONFIGS = ((80,), (64,))
# the degrees D of the rings tc_left takes (those of TC_LIFT_TOWERS), for
# which its stack pre-pass is built (mirrors TC_LEFT_DEGREES in
# csrc/gr_matmul_tc_left.cu)
TC_LEFT_DEGREES = tuple(range(5, MAX_D + 1)) + (21,)
# the tc_left kernel takes up to this many rows t of A (its row tiles hold
# floor(64 / D1) whole values of t); ops.pick_route sends it t up to this
TC_LEFT_MAX_T = 64
# stages of the tc_left kernel's ring, and the bytes of its mbarriers: a
# stage's two and A's (mirror kMaxStages and kBarBytes in
# csrc/gr_matmul_tc_left.cu)
_LEFT_MAX_STAGES = 8
_LEFT_BAR_BYTES = 8 * (2 * _LEFT_MAX_STAGES + 1)
# (threads, cm) instantiations of the skinny kernel beyond every tower's
# default (128, 1): a block of `threads` threads covers threads * cm *
# skinny_cols columns (mirrors SKINNY_EXTRA in csrc/gr_matmul_skinny.cu)
SKINNY_DEFAULT = (128, 1)
SKINNY_CONFIGS = {(d, 1): (SKINNY_DEFAULT, (256, 1), (128, 2)) for d in (1, 2, 3, 4)}
# (threads, tc, cpt) instantiations of the tower kernel, default first: a
# thread holds tc rows x cpt columns of C (mirrors TOWER_CONFIGS in
# csrc/gr_matmul_tower.cu)
TOWER_CONFIGS = {
    (3, 7): ((256, 1, 4), (256, 2, 2), (256, 4, 1), (128, 2, 2)),
    **{t: ((256, 2, 2),) for t in ((9, 1), (11, 1), (13, 1), (15, 1),
                                    (2, 7), (3, 5), (5, 3), (7, 2))},
}


class KernelCounters:
    """Plain counts that let a run show it went through the kernel.

    ``launches_by_route``: launches of each route's matmul kernel (``simt``,
    ``tc``, ``skinny``, ``tower``, ``tc_left``) and of the tc routes'
    pre-passes (``limbs``, two per tc matmul, one per operand, or one for A
    over a lifted tower; ``lift``, one for B over a lifted tower;
    ``stack``, one for B on ``tc_left``; ``left_lift``, one for A on
    ``tc_left``).
    ``launches``: matmul kernel launches of all routes, one per ring matmul
    on the card (the pre-pass not included).

    Worker threads of the elastic backend launch concurrently, so every
    update takes a lock (an unguarded ``+=`` can lose counts).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.launches_by_route = dict.fromkeys(ROUTES + PREPASSES, 0)

    @property
    def launches(self) -> int:
        with self._lock:
            return sum(self.launches_by_route[r] for r in ROUTES)

    def count(self, route: str) -> None:
        with self._lock:
            self.launches_by_route[route] += 1


counters = KernelCounters()


def tower_shape(ring) -> Tuple[int, int]:
    """(D0, D1): the kernel's template parameters for ``ring``."""
    deg = ring.degrees
    if len(deg) > 2:
        raise ValueError(f"{ring}: the kernel takes towers of at most two levels")
    return (deg[0] if deg else 1, deg[1] if len(deg) == 2 else 1)


def simt_instantiated(d0: int, d1: int) -> bool:
    """Whether the simt kernel has an instantiation for the tower (d0, d1);
    mirrors ``GR_TOWERS`` in ``csrc/gr_matmul.cu``."""
    return d0 * d1 <= MAX_D or (d0, d1) in SIMT_WIDE_TOWERS


def simt_thin(ring, t: int) -> bool:
    """Whether simt runs a call of t rows over ``ring`` on its thin kernel
    (the int8 tensor cores): a single-level ring with D <= 4 and t <= 64;
    the tile kernel (CUDA cores) takes every other call.  Mirrors
    ``thin_applies`` in ``csrc/gr_matmul.cu``."""
    d0, d1 = tower_shape(ring)
    return d1 == 1 and d0 <= SIMT_THIN_MAX_D and t <= SIMT_THIN_MAX_T


def _thin_splits(units: int, sms: int, n_st: int) -> int:
    # one split where the units fill four waves of two blocks an SM; else
    # the fewest up to 8 (and the stages) whose last wave is 90% full,
    # else the fullest (mirrors choose_splits)
    slots = _THIN_PER_SM * sms
    most = min(n_st, _THIN_SPLITS)
    if units >= 4 * slots or most <= 1:
        return 1
    best, best_num, best_den = 1, units, -(-units // slots) * slots
    for s in range(1, most + 1):
        num = units * s
        den = -(-num // slots) * slots
        if 10 * num >= 9 * den:
            return s
        if num * best_den > best_num * den:
            best, best_num, best_den = s, num, den
    return best


def simt_grid(ring, b: int, t: int, r: int, s: int, sms: int) -> Tuple[int, ...]:
    """The simt launch of a (b?, t, r) x (r, s) call over ``ring`` on a card
    of ``sms`` SMs, as ``gr_matmul_simt_grid`` in ``csrc/gr_matmul.cu``
    reports it: (thin, blocks, t chunks, s tiles, R splits, rc, nn, wm, wn,
    dynamic shared memory).

    The thin kernel (:func:`simt_thin`): blocks of floor(64 / D) whole t
    (one to four m16 tiles of M(A)), wm x wn warps of rc m16 x nn n8 tiles
    (one row of four warps over one or two m16 tiles, else two rows of four
    on two m16 tiles and one n8 tile each), B stage rows of at most 128
    words, a ring of 3 stages of 32 rows of r; R split up to 8 ways where
    the chunks x s tiles x batch fill fewer than four waves of two blocks
    an SM.
    The tile kernel: (0, blocks, t tiles, s tiles, 1, 0, 0, 0, 0, 0)."""
    if not simt_thin(ring, t):
        bm, bn, _ = kernel_tile(ring)
        rows, cols = -(-t // bm), -(-s // bn)
        return (0, rows * cols * b, rows, cols, 1, 0, 0, 0, 0, 0)
    D = ring.D
    t_blk = min(t, _THIN_ROWS // D)
    mt = -(-D * t_blk // 16)
    bn_max = 128 if D == 1 else 64 if D == 2 else 32
    if mt <= 2:
        rc, wm, wn = mt, 1, 4
        nn = min(bn_max // 32, 4 // rc)
    else:
        rc, wm, wn, nn = 2, 2, 4, 1
    bn = 8 * wn * nn
    chunks, cols, n_st = -(-t // t_blk), -(-s // bn), -(-r // _THIN_BK)
    rsb = bn * D + _THIN_PAD
    smem = 4 * _THIN_STAGES * (_THIN_BK * rsb + t_blk * _THIN_BK * D) + rc * wm * D * 2048
    units = chunks * cols * b
    splits = min(_thin_splits(units, sms, n_st), max(1, min(n_st, _THIN_SPLITS)))
    return (1, units * splits, chunks, cols, splits, rc, nn, wm, wn, smem)


def tc_instantiated(d0: int, d1: int) -> bool:
    """Whether the tc route takes the tower (d0, d1): an instantiation of
    its own, or a lift onto its inner ring's; mirrors ``TC_CONFIGS`` and
    ``TC_LIFT_TOWERS`` in ``csrc/gr_matmul_tc.cu``."""
    view = tc_view(d0, d1)
    return view in TC_CONFIGS or view in TC_LIFT_TOWERS


def tc_configs(d0: int, d1: int) -> Tuple[Tuple[int, int], ...]:
    """The tc kernel's (bn, stages) instantiations for the tower (d0, d1),
    default first (a lifted tower: its inner ring's); empty without any."""
    view = tc_view(d0, d1)
    return TC_CONFIGS.get((view[0], 1) if view in TC_LIFT_TOWERS else view, ())


def tc_left_configs(d0: int, d1: int) -> Tuple[Tuple[int], ...]:
    """The tc_left kernel's (bn,) tile widths for the tower (d0, d1), default
    first: ``TC_LEFT_CONFIGS`` for a lifted ring of ``TC_LIFT_TOWERS``,
    empty for any other."""
    view = tc_view(d0, d1)
    return TC_LEFT_CONFIGS if view[1] > 1 and view in TC_LIFT_TOWERS else ()


def tc_left_layout(ring, config: Tuple[int], rp: int) -> Tuple[bool, bool, int, int, int]:
    """(two row tiles a block, A resident, stages, output buffers a
    consumer, dynamic shared memory) of a tc_left launch of ``config`` over
    ``ring`` at depth ``rp`` (the padded D r; mirrors ``layout`` in
    ``csrc/gr_matmul_tc_left.cu``).  After 1 KB of alignment slack, the
    consumers' output buffers (BN 256 bytes each) and the mbarriers, the
    first that fits of: both consumers on a row tile each, sharing every
    stage of B (BN rows of every plane, 32 deep, rounded up to 1 KB), both
    row tiles of M(A) (64 rows x rp bytes x L planes each) resident, with
    two output buffers a consumer or one, at 4 stages; one row tile
    resident, with two buffers at 4 stages or one at 2; one row tile
    streaming (a stage holds A's 64 rows too), likewise.  As many stages as
    fit, up to 8."""
    bn = config[0]
    L = n_limbs(ring)
    a_box = L * 64 * TC_LEFT_DEPTH
    b_box = -(-L * bn * TC_LEFT_DEPTH // 1024) * 1024
    a_tile = rp // TC_LEFT_DEPTH * a_box
    for pair, resident, buffers, min_stages in ((True, True, 2, 4), (True, True, 1, 4),
                                                (False, True, 2, 4), (False, True, 1, 2),
                                                (False, False, 2, 4), (False, False, 1, 2)):
        fixed = 1024 + 2 * buffers * bn * 256 + _LEFT_BAR_BYTES
        a_bytes = min((1 + pair) * a_tile if resident else 0, SMEM_BLOCK_BYTES)
        stage = b_box if resident else a_box + b_box
        stages = min(_LEFT_MAX_STAGES, (SMEM_BLOCK_BYTES - fixed - a_bytes) // stage)
        layout = pair, resident, stages, buffers, fixed + a_bytes + stages * stage
        if stages >= min_stages:
            return layout
    return layout


def tc_left_default(ring, r: int) -> Tuple[int]:
    """The (bn,) tile width a tc_left call of depth r over ``ring`` runs by
    default: the widest of ``TC_LEFT_CONFIGS`` whose layout takes two row
    tiles a block (:func:`tc_left_layout`: B read from L2 once for both),
    else the widest that keeps A resident, else the widest."""
    rp = tc_left_padded(1, ring.D * r, 1)[1]
    layouts = [(config, tc_left_layout(ring, config, rp)) for config in TC_LEFT_CONFIGS]
    for want in (0, 1):
        for config, layout in layouts:
            if layout[want]:
                return config
    return TC_LEFT_CONFIGS[0]


def tc_stack_block(ring, r: int) -> Tuple[int, int]:
    """(KB, SB) of a block of the stack pre-pass over ``ring`` at r rows of
    B (mirrors ``stack_block`` in ``csrc/gr_matmul_tc_left.cu``): KB bytes
    of the depth (r, k), all of ``tc_left_padded``'s Rp where a tile of 16
    columns fits 48 KB (KB + 8 words a row s), else Rp split evenly into the
    fewest parts that fit, each rounded up to 16 bytes; SB columns of s,
    the most of 128, 64, 32, 16 that fit."""
    rp = tc_left_padded(1, ring.D * r, 1)[1]
    fits = lambda kb, sb: sb * (kb + 8) * 4 <= 48 * 1024  # noqa: E731
    kb, n = rp, 1
    while not fits(kb, 16):
        n += 1
        kb = -(-(-(-rp // n)) // 16) * 16
    sb = 128
    while sb > 16 and not fits(kb, sb):
        sb //= 2
    return kb, sb


def tower_configs(d0: int, d1: int) -> Tuple[Tuple[int, int, int], ...]:
    """The tower kernel's (threads, tc, cpt) instantiations for the tower
    (d0, d1), default first; empty without any."""
    return TOWER_CONFIGS.get((d0, d1), ())


def skinny_configs(d0: int, d1: int) -> Tuple[Tuple[int, int], ...]:
    """The skinny kernel's (threads, cm) instantiations for the tower
    (d0, d1), default first; empty without any."""
    if skinny_cols(d0, d1) is None:
        return ()
    return SKINNY_CONFIGS.get((d0, d1), (SKINNY_DEFAULT,))


def tc_tile(config: Tuple[int, int]) -> Tuple[int, int]:
    """(BM, BN): the block tile of the tc instantiation ``config``."""
    return TC_BM, config[0]


def tc_smem_bytes(ring, config: Tuple[int, int]) -> int:
    """Dynamic shared memory a tc launch of ``config`` over ``ring`` asks
    for (mirrors ``Tc::kSmem`` in ``csrc/gr_matmul_tc.cu``): a ring of
    ``stages`` stages, each a KS-deep box of the 64 + BN rows of every limb
    plane of both operands rounded up to 1 KB (or, if larger, the
    epilogue's exchange of D0 * BN * 256 bytes, which reuses the ring), 1 KB
    of alignment slack and two mbarriers a stage.  The main kernel runs at
    D0 = D, or at a lifted tower's inner degree."""
    bn, stages = config
    d0 = tc_view(*tower_shape(ring))[0]
    planes = d0 * n_limbs(ring)
    stage = -(-planes * (TC_BM + bn) * TC_DEPTH // 1024) * 1024
    return 1024 + max(stages * stage, d0 * bn * 256) + 16 * stages


def tower_smem_bytes(ring, t: int, r: int) -> int:
    """Dynamic shared memory a tower launch of (t, r) over ``ring`` asks for
    (mirrors ``Tower::words`` in ``csrc/gr_matmul_tower.cu``): the t r
    lifted matrices, D rows of DP = D rounded up to 4 words each, FOLD and
    A itself."""
    D, K = ring.D, ring.K
    return 4 * (t * r * D * (-(-D // 4) * 4) + K * D + t * r * D)


def skinny_cols(d0: int, d1: int) -> Optional[int]:
    """Columns per thread of the skinny kernel for the tower (d0, d1), None
    without an instantiation; mirrors ``Skinny`` and ``SKINNY_TOWERS`` in
    ``csrc/gr_matmul_skinny.cu`` (instantiated where K * CPT <= 64)."""
    D, K = d0 * d1, (2 * d0 - 1) * (2 * d1 - 1)
    cpt = 1 if D % 4 == 0 else 2 if D % 2 == 0 else 4
    return cpt if D <= MAX_D and K * cpt <= 64 else None


def skinny_block(ring, t: int, r: int, config=None) -> Tuple[int, int]:
    """(threads, groups) of a block of the skinny launch of (t, r) over
    ``ring`` with ``config`` (None: the default); mirrors ``block_smem`` in
    ``csrc/gr_matmul_skinny.cu``.  Where the block would need more than
    ``SKINNY_SMEM_CAP`` of shared memory (two blocks an SM), a widened call
    (t > 16 or r > 16, t >= ``SKINNY_GROUPS``) splits its rows of C among
    ``SKINNY_GROUPS`` groups of its threads sharing one slab of columns;
    any other halves its threads while it needs more, down to 32."""
    threads, cm = config or SKINNY_DEFAULT
    groups = 1
    if (_skinny_words(ring, t, r, threads, cm) * 4 > SKINNY_SMEM_CAP and (t > 16 or r > 16)
            and t >= SKINNY_GROUPS):
        groups = SKINNY_GROUPS
    while (groups == 1 and threads > 32
           and _skinny_words(ring, t, r, threads, cm) * 4 > SKINNY_SMEM_CAP):
        threads //= 2
    return threads, groups


def _skinny_words(ring, t: int, r: int, cols: int, cm: int) -> int:
    # all of A (rounded up to a 16-byte vector) and the slab of B: r rows
    # of `cols` threads' CPT columns, CPT * D words a thread
    cpt = skinny_cols(*tower_shape(ring)) or 0
    return (t * r * ring.D + 3) // 4 * 4 + r * cols * cpt * cm * ring.D


def skinny_smem_bytes(ring, t: int, r: int, config=None) -> int:
    """Dynamic shared memory the skinny launch of (t, r) over ``ring`` with
    ``config`` (None: the default) asks for: all of A and an r-row slab of
    B for the columns of :func:`skinny_block`'s threads.  The kernel takes
    the call only within ``SMEM_BLOCK_BYTES``."""
    cm = (config or SKINNY_DEFAULT)[1]
    threads, groups = skinny_block(ring, t, r, config)
    return 4 * _skinny_words(ring, t, r, threads // groups, cm)


def tc_shape(ring, t: int, r: int, s: int) -> Tuple[int, int, int, int]:
    """(D0, T, R, S) of the main tc kernel's launch for a (t, r) x (r, s)
    matmul over ``ring``: the ring's own, or over a lifted tower's inner
    ring GR(2^e, D0), (t, D1 r) x (D1 r, D1 s)."""
    d0, d1 = tc_view(*tower_shape(ring))
    return d0, t, d1 * r, d1 * s


def tc_padded(t: int, r: int, s: int) -> Tuple[int, int, int]:
    """(Tp, Rp, Sp): the shape the tc route's limb planes are padded to: T
    and S to the pre-pass's 32, R to the stage depth (the swizzled box's
    64 bytes).  The main kernel's boxes may reach past Tp and Sp (a 64-row
    or BN-row tile): TMA reads those rows as zeros."""
    return -(-t // TC_PAD) * TC_PAD, -(-r // TC_DEPTH) * TC_DEPTH, -(-s // TC_PAD) * TC_PAD


def kernel_tile(ring, t: Optional[int] = None) -> Tuple[int, int, int]:
    """The simt tile of a call of ``t`` rows over ``ring`` (None: past 64
    rows): the thin kernel's (t a block, BN, 32 rows of r a stage) where
    :func:`simt_thin`, else the tile kernel's (BM, BN, BK), which mirrors
    the ``Cfg`` template in ``csrc/gr_matmul.cu`` (both checked against the
    built library by ``chip_smoke.py``)."""
    if t is not None and simt_thin(ring, t):
        grid = simt_grid(ring, 1, t, 1, 1, 1)
        return min(t, _THIN_ROWS // ring.D), 8 * grid[8] * grid[6], _THIN_BK
    D, K = ring.D, ring.K
    tm = next((t for t in (4, 2) if K * t * t + 2 * D * t <= 128), 1)
    bm = 16 * tm
    bk = 16 if D * 16 * 2 * (bm + 1) * 4 <= 48 * 1024 else 8
    return bm, bm, bk


_layouts: dict = {}
_layouts_lock = threading.Lock()


def _check_layout(ring):
    """The kernel hard-codes conv positions from the tower shape; make sure
    the ring's CONVPOS is that layout.  Returns FOLD as (K*D,) uint32 and a
    ctypes pointer to it, cached per ring (building the pointer costs
    microseconds on every launch otherwise) under a lock, so that concurrent
    callers share one array and the pointer never outlives it."""
    with _layouts_lock:
        hit = _layouts.get(ring)
        if hit is not None:
            return hit
        d0, _ = tower_shape(ring)
        i = np.arange(ring.D)[:, None]
        j = np.arange(ring.D)[None, :]
        expect = (i // d0 + j // d0) * (2 * d0 - 1) + (i % d0 + j % d0)
        if not np.array_equal(expect, ring.CONVPOS):
            raise ValueError(f"{ring}: CONVPOS does not match the kernel's tower layout")
        fold = np.ascontiguousarray(ring.FOLD_U32.reshape(-1))
        hit = _layouts[ring] = (fold, fold.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return hit


def _lift_table(ring):
    """RED of a two-level tower (``ref.outer_reduction``) as a contiguous
    uint32 array and a ctypes pointer to it, cached per ring."""
    key = ("lift", ring)
    with _layouts_lock:
        hit = _layouts.get(key)
        if hit is None:
            red = np.ascontiguousarray(outer_reduction(ring), dtype=np.uint32)
            hit = _layouts[key] = (red, red.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return hit


def _check_operand(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 (uint32 bit patterns), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gr_matmul_planar(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """The reference's planar interface on the card: A (b?, D, T, R),
    B (b?, D, R, S) -> C (b?, D, T, S), through :func:`gr_matmul_simt` on
    interleaved copies (the route itself takes the operands as they lie).

    Launches the CUDA kernel or raises; it never falls back.
    """
    if A.dim() not in (3, 4) or B.dim() != A.dim():
        raise ValueError(f"expected (b?, D, T, R) x (b?, D, R, S), got {A.shape} x {B.shape}")
    _check_operand(A, "A")
    _check_operand(B, "B")
    C = gr_matmul_simt(A.movedim(-3, -1).contiguous(), B.movedim(-3, -1).contiguous(), ring)
    return C.movedim(-1, -3).contiguous()


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def _thin_modulus(ring) -> None:
    """The thin kernel lifts A by x^(k+1) a = x (x^k a) with FOLD's row D
    as x^D: make sure ``ring``'s FOLD is that of a single-level extension
    (rows 0..D-1 the identity, row c + 1 = x times row c), cached per ring."""
    key = ("thin", ring)
    with _layouts_lock:
        if key in _layouts:
            return
        D = ring.D
        fold = ring.FOLD_U32.astype(np.uint64)
        ok = np.array_equal(fold[:D], np.eye(D, dtype=np.uint64))
        for c in range(D, ring.K - 1):
            shifted = np.concatenate((np.zeros(1, np.uint64), fold[c, :-1])) + fold[c, -1] * fold[D]
            ok = ok and np.array_equal(shifted & np.uint64(0xFFFFFFFF), fold[c + 1])
        if not ok:
            raise ValueError(f"{ring}: FOLD is not a single-level extension's; the thin kernel "
                             "cannot lift A by its modulus")
        _layouts[key] = True


def gr_matmul_simt(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """The general route (``simt``) on the card: A (b?, t, r, D) x B (b?, r,
    s, D) -> C (b?, t, s, D), interleaved int32, read as they lie, for
    every tower with D <= 16 and the towers of ``SIMT_WIDE_TOWERS``, at any
    shape.  Its thin kernel takes the calls of :func:`simt_thin` (the int8
    tensor cores, R split as :func:`simt_grid` says: then C starts at zero
    and, for e < 32, a counter a tile lets the last split mask it), its tile
    kernel the rest.  The plain version is ``ref.gr_matmul_simt_ref``.

    Launches the CUDA kernel or raises; it never falls back.
    """
    A, B, squeeze, (nb, T, R, S) = _interleaved(A, B, ring)
    d0, d1 = tower_shape(ring)
    if not simt_instantiated(d0, d1):
        raise ValueError(f"{ring}: the simt kernel has no instantiation for its tower")
    _, fold = _check_layout(ring)
    thin = simt_thin(ring, T)
    if thin:
        _thin_modulus(ring)
    elif -(-T // kernel_tile(ring)[0]) > 65535:
        raise ValueError(f"shape {tuple(A.shape)} x {tuple(B.shape)} exceeds the launch grid")
    grid = simt_grid(ring, nb, T, R, S, _sm_count(A.device)) if thin else None
    if thin and grid[1] > 2**31 - 1:
        raise ValueError(f"shape {tuple(A.shape)} x {tuple(B.shape)} exceeds the launch grid")
    split = thin and grid[4] > 1
    alloc = torch.zeros if split else torch.empty
    C = alloc((nb, T, S, ring.D), dtype=torch.int32, device=A.device)
    if C.numel():
        done = None
        if split and ring.e < 32:  # a counter per (batch, s tile, t chunk)
            done = torch.zeros(nb * grid[3] * grid[2], dtype=torch.int32, device=A.device)
        lib = load_library()
        ctx, stream = _stream(A.device)
        with ctx:
            err = lib.gr_matmul_simt_u32(
                A.data_ptr(), B.data_ptr(), C.data_ptr(), None if done is None else done.data_ptr(),
                nb, T, R, S, d0, d1, fold, _mask(ring), n_limbs(ring), _sm_count(A.device),
                grid[4] if thin else 1, stream)
        _check_launch(err, "simt")
        counters.count("simt")
    return C[0] if squeeze else C


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"gr_matmul {what} kernel launch failed: cudaError {err}")


def _interleaved(A: torch.Tensor, B: torch.Tensor, ring):
    """Validate interleaved operands (b?, t, r, D) x (b?, r, s, D); returns
    them with a batch axis, whether to drop it again, and (b, t, r, s)."""
    if ring.p != 2 or ring.e > 32:
        raise ValueError(f"{ring} lies outside the kernels' envelope (p=2, e<=32)")
    _check_operand(A, "A")
    _check_operand(B, "B")
    if A.device != B.device:
        raise ValueError(f"A on {A.device}, B on {B.device}")
    squeeze = A.dim() == 3
    if squeeze:
        A, B = A.unsqueeze(0), B.unsqueeze(0)
    if A.dim() != 4 or B.dim() != 4:
        raise ValueError(f"expected (b, t, r, D) x (b, r, s, D), got {A.shape} x {B.shape}")
    nb, T, R, D = A.shape
    if (B.shape[0], B.shape[1], B.shape[3]) != (nb, R, D) or D != ring.D:
        raise ValueError(f"shape mismatch {tuple(A.shape)} x {tuple(B.shape)} for {ring}")
    S = B.shape[2]
    if nb > 65535 or max(T, R, S) >= 2**31 - 256:
        raise ValueError(f"shape {tuple(A.shape)} x {tuple(B.shape)} exceeds the launch grid")
    return A, B, squeeze, (nb, T, R, S)


def _mask(ring) -> int:
    return (2**ring.e - 1) if ring.e < 32 else 0xFFFFFFFF


def _stream(device: torch.device):
    """PyTorch's current stream on ``device``, entering the device only when
    it is not the current one (the kernels launch on the current device)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext(), torch.cuda.current_stream(device).cuda_stream
    return torch.cuda.device(device), torch.cuda.current_stream(device).cuda_stream


def gr_matmul_skinny(A: torch.Tensor, B: torch.Tensor, ring, config=None) -> torch.Tensor:
    """The bandwidth route on the card: A (b?, t, r, D) x B (b?, r, s, D) ->
    C (b?, t, s, D), interleaved int32, for t <= 64 and r <= 32 within a
    block's shared memory (``skinny_smem_bytes``), with the (threads, cm)
    instantiation ``config`` (None: the tower's default).

    Launches the CUDA kernel or raises; it never falls back.
    """
    A, B, squeeze, (nb, T, R, S) = _interleaved(A, B, ring)
    d0, d1 = tower_shape(ring)
    configs = skinny_configs(d0, d1)
    if not configs:
        raise ValueError(f"{ring}: the skinny kernel has no instantiation for tower {(d0, d1)}")
    config = configs[0] if config is None else tuple(config)
    if config not in configs:
        raise ValueError(f"{ring}: the skinny kernel has no instantiation {config}; "
                         f"built: {configs}")
    if not (1 <= T <= SKINNY_MAX_T and 1 <= R <= SKINNY_MAX_R):
        raise ValueError(f"the skinny kernel takes 1 <= t <= {SKINNY_MAX_T}, 1 <= r <= "
                         f"{SKINNY_MAX_R}, got t={T}, r={R}")
    if skinny_smem_bytes(ring, T, R, config) > SMEM_BLOCK_BYTES:
        raise ValueError(f"{ring}: skinny {config} at t={T}, r={R} needs "
                         f"{skinny_smem_bytes(ring, T, R, config)} B of shared memory, more than "
                         f"a block's {SMEM_BLOCK_BYTES}")
    _, fold = _check_layout(ring)
    C = torch.empty((nb, T, S, ring.D), dtype=torch.int32, device=A.device)
    if C.numel():
        lib = load_library()
        ctx, stream = _stream(A.device)
        with ctx:
            err = lib.gr_matmul_skinny_u32(A.data_ptr(), B.data_ptr(), C.data_ptr(), nb, T, R, S,
                                           d0, d1, *config, fold, _mask(ring), stream)
        _check_launch(err, "skinny")
        counters.count("skinny")
    return C[0] if squeeze else C


def tc_lift(B: torch.Tensor, ring) -> torch.Tensor:
    """The tc route's lift pre-pass on the card, for a lifted tower
    (D0, D1) of ``TC_LIFT_TOWERS`` (``ref.tc_view``; a single-level ring as
    (1, D)): B (b?, r, s, D) int32 -> B8 (b, D0, L, Sp, Rp) uint8, the limb
    planes of M(B) (``ref.lift_b_ref``), K-major and zero-padded to
    ``tc_padded(., D1 r, D1 s)``.  One launch, counted as ``lift``; the
    plain version is ``ref.tc_planes_ref``'s B side."""
    _check_operand(B, "B")
    if ring.p != 2 or ring.e > 32:
        raise ValueError(f"{ring} lies outside the kernels' envelope (p=2, e<=32)")
    d0, d1 = tc_view(*tower_shape(ring))
    if (d0, d1) not in TC_LIFT_TOWERS:
        raise ValueError(f"{ring}: the lift pre-pass has no instantiation for tower {(d0, d1)}")
    if B.dim() == 3:
        B = B.unsqueeze(0)
    if B.dim() != 4 or B.shape[-1] != ring.D:
        raise ValueError(f"expected (b?, r, s, D) for {ring}, got {tuple(B.shape)}")
    nb, R, S, _ = B.shape
    _, Rp, Sp = tc_padded(1, d1 * R, d1 * S)
    L = n_limbs(ring)
    B8 = torch.empty((nb, d0, L, Sp, Rp), dtype=torch.uint8, device=B.device)
    if B8.numel():
        lib = load_library()
        ctx, stream = _stream(B.device)
        with ctx:
            err = lib.gr_matmul_tc_lift(B.data_ptr(), B8.data_ptr(), nb, R, S, d0, d1, L, Rp, Sp,
                                        _lift_table(ring)[1], stream)
        _check_launch(err, "lift pre-pass")
        counters.count("lift")
    return B8


def tc_limbs(A: torch.Tensor, B: torch.Tensor, ring):
    """The tc route's pre-passes on the card.  Returns (A8, B8): A8 (b, D0,
    L, Tp, Rp) and B8 (b, D0, L, Sp, Rp) uint8, K-major and zero-padded to
    ``tc_padded`` of the main kernel's (T, R, S) (``tc_shape``).  A
    ring the kernel takes as it is: two limb pre-pass launches, counted as
    ``limbs``.  A lifted tower (D0, D1): one ``limbs`` launch on A read as
    (t, D1 r, D0) and the lift of B (:func:`tc_lift`).  The plain version
    is ``ref.tc_planes_ref``."""
    A, B, _, (nb, T, R, S) = _interleaved(A, B, ring)
    d0, d1 = tc_view(*tower_shape(ring))
    if not tc_instantiated(d0, d1):
        raise ValueError(f"{ring}: the tc kernel has no instantiation for tower {(d0, d1)}")
    _, T, R1, S1 = tc_shape(ring, T, R, S)
    Tp, Rp, Sp = tc_padded(T, R1, S1)
    L = n_limbs(ring)
    A8 = torch.empty((nb, d0, L, Tp, Rp), dtype=torch.uint8, device=A.device)
    lib = load_library()
    ctx, stream = _stream(A.device)
    with ctx:
        if A8.numel():
            err = lib.gr_matmul_tc_limbs(A.data_ptr(), A8.data_ptr(), nb, T, R1, d0, L, Tp, Rp,
                                         0, stream)
            _check_launch(err, "limb pre-pass")
            counters.count("limbs")
        if d1 > 1:
            return A8, tc_lift(B, ring)
        B8 = torch.empty((nb, d0, L, Sp, Rp), dtype=torch.uint8, device=A.device)
        if B8.numel():
            err = lib.gr_matmul_tc_limbs(B.data_ptr(), B8.data_ptr(), nb, R, S, d0, L, Rp, Sp,
                                         1, stream)
            _check_launch(err, "limb pre-pass")
            counters.count("limbs")
    return A8, B8


def gr_matmul_tc(A: torch.Tensor, B: torch.Tensor, ring, config=None) -> torch.Tensor:
    """The tensor-core route on the card: A (b?, t, r, D) x B (b?, r, s, D)
    -> C (b?, t, s, D), interleaved int32, with the (bn, stages)
    instantiation ``config`` (None: the tower's default).  Runs the
    pre-passes (:func:`tc_limbs`), then the wgmma kernel over the ring, or
    over a lifted tower's inner ring with the inner FOLD: its (t, D1 s, D0)
    output is C as it lies.

    Launches the CUDA kernels or raises; it never falls back.
    """
    A, B, squeeze, (nb, T, R, S) = _interleaved(A, B, ring)
    d0, d1 = tc_view(*tower_shape(ring))
    configs = tc_configs(d0, d1)
    if not configs:
        raise ValueError(f"{ring}: the tc kernel has no instantiation for tower {(d0, d1)}")
    config = configs[0] if config is None else tuple(config)
    if config not in configs:
        raise ValueError(f"{ring}: the tc kernel has no instantiation {config}; built: {configs}")
    if tc_smem_bytes(ring, config) > SMEM_BLOCK_BYTES:
        raise ValueError(f"{ring}: tc {config} needs {tc_smem_bytes(ring, config)} B of shared "
                         f"memory, more than a block's {SMEM_BLOCK_BYTES}")
    _, fold = _check_layout(ring.base_ring() if d1 > 1 else ring)
    _, T, R1, S1 = tc_shape(ring, T, R, S)
    Tp, Rp, Sp = tc_padded(T, R1, S1)
    if -(-T // TC_BM) > 65535 or max(R1, S1) >= 2**31 - 256:
        raise ValueError(f"{(T, R1, S1)} exceeds the tc kernel's launch grid")
    C = torch.empty((nb, T, S, ring.D), dtype=torch.int32, device=A.device)
    if C.numel() == 0:
        return C[0] if squeeze else C
    A8, B8 = tc_limbs(A, B, ring)
    lib = load_library()
    ctx, stream = _stream(A.device)
    with ctx:
        err = lib.gr_matmul_tc_u32(A8.data_ptr(), B8.data_ptr(), C.data_ptr(), nb, T, S1, Tp, Sp,
                                   Rp, n_limbs(ring), d0, 1, *config, fold, _mask(ring), stream)
    _check_launch(err, "tc")
    counters.count("tc")
    return C[0] if squeeze else C


def _left_degree(ring) -> int:
    """D of a ring the tc_left route takes (a lifted ring of
    ``TC_LIFT_TOWERS``), or raise."""
    d0, d1 = tc_view(*tower_shape(ring))
    if d1 == 1 or (d0, d1) not in TC_LIFT_TOWERS:
        raise ValueError(f"{ring}: the tc_left route has no instantiation for tower {(d0, d1)} "
                         f"(it takes the lifted towers {TC_LIFT_TOWERS})")
    if ring.p != 2 or ring.e > 32:
        raise ValueError(f"{ring} lies outside the kernels' envelope (p=2, e<=32)")
    return ring.D


def _mult_table(ring, device):
    """MT[i][k][m] = FOLD[CONVPOS(i, k), m] (D, D, D) as int32 on ``device``,
    cached per ring and device: M(a)[k, m] = sum_i a_i MT[i][k][m]."""
    key = ("mult", ring, str(device))
    with _layouts_lock:
        hit = _layouts.get(key)
        if hit is None:
            mt = ring.FOLD_U32[np.asarray(ring.CONVPOS)].astype(np.uint32)  # (i, k, m)
            hit = _layouts[key] = torch.from_numpy(mt.view(np.int32).copy()).to(device)
        return hit


def tc_left_lift(A: torch.Tensor, ring) -> torch.Tensor:
    """The tc_left route's lift pre-pass on the card: A (b?, t, r, D) int32
    -> A8 (b, 1, L, Tp, Rp) uint8, the limb planes of A's multiplication
    matrices over Z_2^e, M(A)[(t, m), (r, k)] = sum_i A[t, r, i]
    FOLD[CONVPOS(i, k), m] (``ref.left_lift_ref``), K-major and zero-padded
    to ``tc_left_padded(D t, D r, .)``.  One launch, counted as ``left_lift``;
    the plain version is ``ref.tc_left_planes_ref``'s A side."""
    _check_operand(A, "A")
    D = _left_degree(ring)
    if A.dim() == 3:
        A = A.unsqueeze(0)
    if A.dim() != 4 or A.shape[-1] != D:
        raise ValueError(f"expected (b?, t, r, D) for {ring}, got {tuple(A.shape)}")
    nb, T, R, _ = A.shape
    if nb > 65535:
        raise ValueError(f"batch {nb} exceeds the launch grid")
    Tp, Rp, _ = tc_left_padded(D * T, D * R, 1)
    L = n_limbs(ring)
    A8 = torch.empty((nb, 1, L, Tp, Rp), dtype=torch.uint8, device=A.device)
    if A8.numel():
        mt = _mult_table(ring, A.device)
        lib = load_library()
        ctx, stream = _stream(A.device)
        with ctx:
            err = lib.gr_matmul_tc_left_lift(A.data_ptr(), mt.data_ptr(), A8.data_ptr(), nb, T, R,
                                             D, L, Tp, Rp, stream)
        _check_launch(err, "tc_left lift pre-pass")
        counters.count("left_lift")
    return A8


def tc_stack(B: torch.Tensor, ring) -> torch.Tensor:
    """The tc_left route's stack pre-pass on the card: B (b?, r, s, D) int32
    -> B8 (b, 1, L, Sp, Rp) uint8, byte l of B[r, s, k] at plane l, row s,
    column D r + k (B read as (D r, s) over Z_2^e), zero-padded to
    ``tc_left_padded(., D r, s)``.  One launch, counted as ``stack``; the
    plain version is ``ref.stacked_planes_ref``."""
    _check_operand(B, "B")
    D = _left_degree(ring)
    if B.dim() == 3:
        B = B.unsqueeze(0)
    if B.dim() != 4 or B.shape[-1] != D:
        raise ValueError(f"expected (b?, r, s, D) for {ring}, got {tuple(B.shape)}")
    nb, R, S, _ = B.shape
    if nb > 65535:
        raise ValueError(f"batch {nb} exceeds the launch grid")
    _, Rp, Sp = tc_left_padded(1, D * R, S)
    L = n_limbs(ring)
    B8 = torch.empty((nb, 1, L, Sp, Rp), dtype=torch.uint8, device=B.device)
    if B8.numel():
        lib = load_library()
        ctx, stream = _stream(B.device)
        with ctx:
            err = lib.gr_matmul_tc_stack(B.data_ptr(), B8.data_ptr(), nb, R, S, D, L, Rp, Sp,
                                         stream)
        _check_launch(err, "stack pre-pass")
        counters.count("stack")
    return B8


def tc_left_limbs(A: torch.Tensor, B: torch.Tensor, ring):
    """The tc_left route's pre-passes on the card.  Returns (A8, B8): A8
    (b, 1, L, Tp, Rp), the limb planes of M(A) (rows (t, m), depth (r, k);
    :func:`tc_left_lift`), and B8 (b, 1, L, Sp, Rp), B's (:func:`tc_stack`),
    padded to ``tc_left_padded(D t, D r, s)``.  The plain version is
    ``ref.tc_left_planes_ref``."""
    A, B, _, _ = _interleaved(A, B, ring)
    return tc_left_lift(A, ring), tc_stack(B, ring)


def gr_matmul_tc_left(A: torch.Tensor, B: torch.Tensor, ring, config=None) -> torch.Tensor:
    """The tensor-core route with the lift on the left operand, on the card:
    A (b?, t, r, D) x B (b?, r, s, D) -> C (b?, t, s, D), interleaved int32,
    over a lifted ring of ``TC_LIFT_TOWERS``, for 1 <= t <=
    ``TC_LEFT_MAX_T``, with the (bn,) tile width ``config``
    (``TC_LEFT_CONFIGS``; None: :func:`tc_left_default`'s).  Runs the pre-passes
    (:func:`tc_left_limbs`), then the tc_left kernel over Z_2^e on M(A)
    (D t, D r) and B read as (D r, s): row tiles of floor(64 / D) whole t,
    product row (t, m) written to C[t, s, m].  The plain version is
    ``ref.gr_matmul_tc_left_ref``.

    Launches the CUDA kernels or raises; it never falls back.
    """
    A, B, squeeze, (nb, T, R, S) = _interleaved(A, B, ring)
    D = _left_degree(ring)
    config = tc_left_default(ring, R) if config is None else tuple(config)
    if config not in TC_LEFT_CONFIGS:
        raise ValueError(f"{ring}: the tc_left kernel has no instantiation {config}; "
                         f"built: {TC_LEFT_CONFIGS}")
    if not 1 <= T <= TC_LEFT_MAX_T:
        raise ValueError(f"the tc_left kernel takes 1 <= t <= {TC_LEFT_MAX_T}, got t={T}")
    _, Rp, _ = tc_left_padded(D * T, D * R, S)
    if tc_left_layout(ring, config, Rp)[2] < 2:
        raise ValueError(f"{ring}: tc_left {config} fits fewer than two stages")
    if -(-S // config[0]) > 2**31 - 1 or max(D * R, S) >= 2**31 - 256:
        raise ValueError(f"{(D * T, D * R, S)} exceeds the tc_left kernel's launch grid")
    if nb * T * S == 0:
        C = torch.empty((nb, T, S, ring.D), dtype=torch.int32, device=A.device)
        return C[0] if squeeze else C
    A8, B8 = tc_left_limbs(A, B, ring)
    C = tc_left_main(A8, B8, ring, T, S, config)
    return C[0] if squeeze else C


def tc_left_main(A8: torch.Tensor, B8: torch.Tensor, ring, t: int, s: int,
                 config=None) -> torch.Tensor:
    """The tc_left kernel alone on the card, on its pre-passes' planes (A8
    (b, 1, L, Tp, Rp) of M(A) and B8 (b, 1, L, Sp, Rp) of B', from
    :func:`tc_left_limbs`) of a (t, r) x (r, s) call over ``ring``, with the
    (bn,) tile width ``config`` (None: :func:`tc_left_default`'s): C (b, t,
    s, D) int32.  One launch, counted as ``tc_left``."""
    D = _left_degree(ring)
    nb, _, _, Tp, Rp = A8.shape
    config = tc_left_default(ring, Rp // D) if config is None else tuple(config)
    Sp = B8.shape[-2]
    L = n_limbs(ring)
    if (A8.shape[:3] != (nb, 1, L) or tuple(B8.shape) != (nb, 1, L, Sp, Rp)
            or Tp < D * t or Sp < s or A8.dtype != torch.uint8 or B8.dtype != torch.uint8
            or not (A8.is_cuda and A8.is_contiguous() and B8.is_contiguous())):
        raise ValueError(f"tc_left planes {tuple(A8.shape)}, {tuple(B8.shape)} do not fit "
                         f"t={t}, s={s} over {ring}")
    C = torch.empty((nb, t, s, D), dtype=torch.int32, device=A8.device)
    lib = load_library()
    ctx, stream = _stream(A8.device)
    with ctx:
        err = lib.gr_matmul_tc_left_u32(A8.data_ptr(), B8.data_ptr(), C.data_ptr(), nb, t, s, Tp,
                                        Sp, Rp, L, D, *config, _mask(ring), stream)
    _check_launch(err, "tc_left")
    counters.count("tc_left")
    return C


def tc_left_grid(ring, b: int, t: int, r: int, s: int, config, sms: int) -> Tuple[int, int, int]:
    """(blocks, row tiles, column tiles) of a tc_left launch on a card of
    ``sms`` SMs (mirrors ``grid_of`` in ``csrc/gr_matmul_tc_left.cu``, which
    the C ``gr_matmul_tc_left_grid`` exports): row tiles of floor(64 / D)
    whole t, taken two a block where :func:`tc_left_layout` pairs them,
    column tiles ``bn`` wide, and about one block an SM, each batch entry's
    row tiles (or pairs) taking as many blocks each."""
    row_tiles = -(-t // (64 // ring.D))
    pair = tc_left_layout(ring, config, tc_left_padded(1, ring.D * r, 1)[1])[0]
    units = -(-row_tiles // 2) if pair else row_tiles
    col_tiles = -(-s // config[0])
    groups = min(max(1, sms // (units * b)), col_tiles)
    return units * groups * b, row_tiles, col_tiles


def gr_matmul_tower(A: torch.Tensor, B: torch.Tensor, ring, config=None) -> torch.Tensor:
    """The tower route on the card: A (b?, t, r, D) x B (b?, r, s, D) ->
    C (b?, t, s, D), interleaved int32, for 1 <= t, r <= 16 whose lifted A
    fits a block (``tower_smem_bytes``), with the (threads, tc, cpt)
    instantiation ``config`` (None: the tower's default).

    Launches the CUDA kernel or raises; it never falls back.
    """
    A, B, squeeze, (nb, T, R, S) = _interleaved(A, B, ring)
    d0, d1 = tower_shape(ring)
    configs = tower_configs(d0, d1)
    if not configs:
        raise ValueError(f"{ring}: the tower kernel has no instantiation for tower {(d0, d1)}")
    config = configs[0] if config is None else tuple(config)
    if config not in configs:
        raise ValueError(f"{ring}: the tower kernel has no instantiation {config}; "
                         f"built: {configs}")
    if not (1 <= T <= TOWER_MAX_TR and 1 <= R <= TOWER_MAX_TR):
        raise ValueError(f"the tower kernel takes 1 <= t, r <= {TOWER_MAX_TR}, got t={T}, r={R}")
    if tower_smem_bytes(ring, T, R) > SMEM_BLOCK_BYTES:
        raise ValueError(f"{ring}: the tower kernel's lifted A at t={T}, r={R} needs "
                         f"{tower_smem_bytes(ring, T, R)} B of shared memory, more than a "
                         f"block's {SMEM_BLOCK_BYTES}")
    _, fold = _check_layout(ring)
    C = torch.empty((nb, T, S, ring.D), dtype=torch.int32, device=A.device)
    if C.numel():
        lib = load_library()
        ctx, stream = _stream(A.device)
        with ctx:
            err = lib.gr_matmul_tower_u32(A.data_ptr(), B.data_ptr(), C.data_ptr(), nb, T, R, S,
                                          d0, d1, *config, fold, _mask(ring), stream)
        _check_launch(err, "tower")
        counters.count("tower")
    return C[0] if squeeze else C
