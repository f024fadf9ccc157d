"""Dispatch around the Galois-ring matmul kernels.

Counterpart of ``repro.kernels.ops``: picks the path of every ring matmul
of the port, which all come through :func:`gr_matmul`:

* CPU tensors take the plain PyTorch version (``ref.gr_matmul_ref``);
* CUDA tensors of a ring inside the envelope (``kernel_supported``) launch
  one of five hand-written routes, or raise.  :func:`pick_route` decides
  which, before any launch, from the ring and the shape alone.

The routes' envelope (what :func:`route_takes` says each kernel takes;
:func:`pick_route` asks in this order):

* ``skinny`` for t <= 64 and r <= 32 (the RMFE packs, the encodes and the
  decode of a CDMM round with up to N = 64 workers) over the towers with
  K * CPT <= 64 (``gr_matmul.skinny_cols``: GR(2^e, D) for D <= 8 and the
  even D to 16, and (2, 3), (2, 5), (3, 2), (3, 4), (4, 3), (5, 2)), where
  A and its slab of B fit a block's shared memory
  (``gr_matmul.skinny_smem_bytes``);
* ``tower`` for t, r <= 16 over the towers ``skinny`` has no instantiation
  for (``gr_matmul.TOWER_CONFIGS``: the (3, 7) tower, (3, 5), (5, 3),
  (7, 2), ...), where the lifted A fits a block (t r <= 108 over the (3, 7)
  tower, t r <= 225 over (3, 5));
* ``tc_left`` for t <= ``TC_LEFT_MAX_T`` = 64, D1 t >= 64 and s >= 64 over
  the lifted rings of ``gr_matmul.TC_LIFT_TOWERS`` (below): the decodes
  and encodes the bandwidth routes do not take, whose left operand is a
  small host-built matrix (the 16 x 33 decode of the secure plans for 64
  workers over GR(2^e, 7), the 32 x 32 decode and the 64-row encodes of
  the (3, 7) tower's round for 64 workers).  A persistent wgmma kernel of
  its own over Z_2^e, with A lifted to its multiplication matrices
  (``ref.gr_matmul_tc_left_ref``): B is read as it lies, not lifted to D1
  times its size;
* ``tc`` for t >= 64 and D1 s >= 64 (the worker products): GR(2^e, D)
  with D <= 4 as it is; every other ring of ``gr_matmul.TC_LIFT_TOWERS``
  lifted onto its inner ring (``ref.tc_view``): GR(2^e, D) with
  5 <= D <= 16 as the tower (1, D) over Z_2^e, and the two-level towers
  (2, 3), (2, 5), (2, 7), (3, 2), (3, 4), (3, 5), (4, 3), (3, 7) over
  GR(2^e, D0) (D1 = 1 for a ring taken as it is);
* ``simt`` for everything else: products below ``TC_MIN_TS`` that the
  bandwidth routes do not take (the worker products of ``CodedQuantMatmul``
  below 128 tokens, ep's 48 x 96 worker blocks at 96^3), the towers
  (5, 2), (5, 3) and (7, 2), whose inner degree has no tc instantiation,
  and a lifted ring's calls with D1 t < 64 or s < 64 that ``skinny`` and
  ``tower`` do not take.  Two kernels (``gr_matmul.simt_thin``): t <= 64
  over GR(2^e, D <= 4) on the int8 tensor cores (``mma.sync`` on A's
  multiplication matrices over Z_2^e, lifted in the kernel a stage at a
  time, B streamed once as it lies; R split where the grid is small:
  ``gr_matmul.simt_grid``); every other call on a tile kernel of uint32
  multiply-adds on the CUDA cores (``csrc/gr_matmul.cu`` notes why each
  ring takes which);
* CUDA tensors of a ring outside the envelope raise ValueError: on the
  card a ring matmul runs on a kernel or not at all (the reference hands
  such rings to XLA, ``repro/kernels/ops.py:66``).  The envelope is the
  reference's (p = 2, e <= 32, D <= 16) plus the towers of
  ``SIMT_WIDE_TOWERS``.

``tc``, ``skinny`` and ``tower`` come in a few instantiations each; :func:`pick_blocks`
names the one a launch uses: the caller's, else the tuned entry of
``kernels.autotune``'s cache for this (card, ring, shape), else the
route's default.  ``tc_left`` runs the tile width
``gr_matmul.tc_left_default`` picks from its layout (the autotuner does not
time it), ``simt`` its static tile.

Every route takes the interleaved (t, r, D) layout as it is.  The kernels
mask ragged edges themselves (``tc`` pads inside its limb pre-pass), so
nothing is padded or copied here.
"""
from __future__ import annotations

from typing import Optional

import torch

from .gr_matmul import (
    MAX_D,
    SIMT_WIDE_TOWERS,
    SKINNY_MAX_R,
    SKINNY_MAX_T,
    SMEM_BLOCK_BYTES,
    TC_LEFT_MAX_T,
    TOWER_MAX_TR,
    gr_matmul_simt,
    gr_matmul_skinny,
    gr_matmul_tc,
    gr_matmul_tc_left,
    gr_matmul_tower,
    kernel_tile,
    skinny_cols,
    skinny_configs,
    skinny_smem_bytes,
    tc_configs,
    tc_instantiated,
    tc_left_configs,
    tc_left_default,
    tower_configs,
    tower_shape,
    tower_smem_bytes,
)
from .ref import gr_matmul_ref, tc_view

# the tc route needs at least this many rows and columns.  Below it (a
# 48-row worker product, say) tc can still be faster on the device, but the
# host time of its limb pre-pass launches makes the call slower end to end
# (chip_smoke.py's thresholds block times both)
TC_MIN_TS = 64
# tc_left takes a lifted ring's calls up to TC_LEFT_MAX_T = 64 rows (A's
# side is lifted, so its D1 t rows are the main kernel's): the decodes and
# encodes, up to the 64-row encodes of 64 workers, where chip_smoke.py
# phase 4 times it against the B-lifted tc in turns

__all__ = [
    "TC_LEFT_MAX_T",
    "TC_MIN_TS",
    "gr_matmul",
    "pick_route",
    "route_takes",
    "run_route",
    "coded_encode",
    "kernel_supported",
    "kernel_auto_enabled",
    "pick_blocks",
]


def pick_blocks(ring, t: Optional[int] = None, r: Optional[int] = None,
                s: Optional[int] = None, *, route: Optional[str] = None,
                device=None) -> tuple:
    """The configuration a launch of ``route`` (None: ``pick_route``'s) at
    (t, r, s) over ``ring`` on ``device`` (None: the current card) uses:

    * ``simt``: its static tile at t (``gr_matmul.kernel_tile``: the thin
      kernel's (t a block, BN, 32) or the tile kernel's (BM, BN, BK)); no
      shape given: the tile kernel's;
    * ``tc`` (bn, stages), ``skinny`` (threads, cm) and ``tower``
      (threads, tc, cpt): the tuned entry of the autotune cache for this
      card, ring and shape, else the route's default (its first
      instantiation), None for a tower it has none for;
    * ``tc_left``: the (bn,) tile width ``gr_matmul.tc_left_default`` picks
      for the depth r.

    ``device``: a torch device, or a device kind (``cuda|<card>``).
    """
    if t is None:
        return kernel_tile(ring)
    route = route or pick_route(ring, t, r, s)
    if route == "simt":
        return kernel_tile(ring, t)
    if route == "tc_left":
        return tc_left_default(ring, r) if tc_left_configs(*tower_shape(ring)) else None
    # imported here: ``python -m repro_torch.kernels.autotune`` runs it as __main__
    from .autotune import cached_blocks

    tuned = cached_blocks(ring, t, r, s, device, route=route)
    if tuned is not None:
        return tuned
    configs = {"tc": tc_configs, "skinny": skinny_configs,
               "tower": tower_configs}[route](*tower_shape(ring))
    return configs[0] if configs else None  # the wrapper raises: no instantiation


def kernel_supported(ring) -> bool:
    return ring.p == 2 and ring.e <= 32 and (
        ring.D <= MAX_D or tuple(ring.degrees) in SIMT_WIDE_TOWERS)


def kernel_auto_enabled(ring, x: torch.Tensor) -> bool:
    """True when a ring matmul on ``x`` goes to the kernel: the tensor is
    on CUDA and the ring is inside the envelope."""
    return x.is_cuda and kernel_supported(ring)


def route_takes(route: str, ring, t: int, r: int) -> bool:
    """Whether ``route``'s kernel takes a (t, r) x (r, s) matmul over
    ``ring`` (inside the envelope; for ``tc`` at any t and s, which
    :func:`pick_route` holds to ``TC_MIN_TS``): the instantiations and, for
    ``skinny`` and ``tower``, the shapes and the shared memory a block
    needs at them; ``tc_left`` takes the lifted towers at any shape."""
    d0, d1 = tower_shape(ring)
    if route == "tc":
        return tc_instantiated(d0, d1)
    if route == "tc_left":
        return tc_view(d0, d1)[1] > 1 and tc_instantiated(d0, d1)
    if route == "skinny":
        return (bool(skinny_cols(d0, d1)) and 1 <= t <= SKINNY_MAX_T and 1 <= r <= SKINNY_MAX_R
                and skinny_smem_bytes(ring, t, r) <= SMEM_BLOCK_BYTES)
    if route == "tower":
        return (bool(tower_configs(d0, d1)) and 1 <= t <= TOWER_MAX_TR and 1 <= r <= TOWER_MAX_TR
                and tower_smem_bytes(ring, t, r) <= SMEM_BLOCK_BYTES)
    return route == "simt"


def pick_route(ring, t: int, r: int, s: int) -> str:
    """The route of a (t, r) x (r, s) matmul over ``ring`` on the card:
    ``skinny``, ``tower``, ``tc_left``, ``tc`` or ``simt`` (the first of
    them that takes it: tc_left up to t = ``TC_LEFT_MAX_T`` with its main
    kernel's D1 t and s, tc with its t and D1 s, at least ``TC_MIN_TS``),
    or ``plain`` outside the envelope (which only CPU tensors take:
    :func:`gr_matmul` raises on the card)."""
    if not kernel_supported(ring):
        return "plain"
    for route in ("skinny", "tower"):
        if route_takes(route, ring, t, r):
            return route
    d1 = tc_view(*tower_shape(ring))[1]
    if (t <= TC_LEFT_MAX_T and d1 * t >= TC_MIN_TS and s >= TC_MIN_TS
            and route_takes("tc_left", ring, t, r)):
        return "tc_left"
    if t >= TC_MIN_TS and d1 * s >= TC_MIN_TS and route_takes("tc", ring, t, r):
        return "tc"
    return "simt"


def run_route(route: str, A: torch.Tensor, B: torch.Tensor, ring, config=None) -> torch.Tensor:
    """Launch ``route`` on contiguous CUDA operands (b?, t, r, D) x
    (b?, r, s, D) -> (b?, t, s, D) with ``config`` (None:
    :func:`pick_blocks`'); raises where the route's kernel does not take
    them."""
    if route in ("skinny", "tc", "tower", "tc_left") and config is None:
        config = pick_blocks(ring, A.shape[-3], A.shape[-2], B.shape[-2], route=route,
                             device=A.device)
    if route == "skinny":
        return gr_matmul_skinny(A, B, ring, config)
    if route == "tc":
        return gr_matmul_tc(A, B, ring, config)
    if route == "tc_left":
        return gr_matmul_tc_left(A, B, ring, config)
    if route == "tower":
        return gr_matmul_tower(A, B, ring, config)
    if route == "simt":
        return gr_matmul_simt(A, B, ring)
    raise ValueError(f"unknown route {route!r}")


def gr_matmul(A: torch.Tensor, B: torch.Tensor, ring) -> torch.Tensor:
    """Ring matmul (..., t, r, D) x (..., r, s, D) -> (..., t, s, D).

    Up to one leading batch axis, shared by A and B (one launch for all).
    """
    if A.shape[-1] != ring.D or B.shape[-1] != ring.D or A.shape[-2] != B.shape[-3]:
        raise ValueError(f"shape mismatch {tuple(A.shape)} x {tuple(B.shape)} for {ring}")
    if A.dim() != B.dim() or A.dim() not in (3, 4) or A.shape[:-3] != B.shape[:-3]:
        raise ValueError(f"expected matching (b?, t, r, D) x (b?, r, s, D), got "
                         f"{tuple(A.shape)} x {tuple(B.shape)}")
    if A.device != B.device:
        raise ValueError(f"A on {A.device}, B on {B.device}")
    if kernel_auto_enabled(ring, A):
        route = pick_route(ring, A.shape[-3], A.shape[-2], B.shape[-2])
        return run_route(route, A.contiguous(), B.contiguous(), ring)
    if A.is_cuda:
        raise ValueError(f"{ring} lies outside the kernels' envelope: no kernel takes its "
                         "ring matmuls on the card (run on the CPU for the plain version)")
    return gr_matmul_ref(A, B, ring)


def coded_encode(V: torch.Tensor, blocks_mat: torch.Tensor, ring) -> torch.Tensor:
    """CDMM encode = ring matmul against a Vandermonde slice.

    V: (N, K, D); blocks_mat: (K, M, D) -> (N, M, D)."""
    return gr_matmul(V, blocks_mat, ring)
