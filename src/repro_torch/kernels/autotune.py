"""Kernel autotuner: measured configurations of the ``tc``, ``skinny`` and
``tower`` routes, counterpart of ``repro.kernels.autotune``.

The reference tunes the (bt, bs, br) blocks of its Pallas kernel against a
VMEM budget.  On Hopper the routes are compiled CUDA, so a candidate is one
of the instantiations the built library has (``gr_matmul.TC_CONFIGS``,
``gr_matmul.SKINNY_CONFIGS``, ``gr_matmul.TOWER_CONFIGS``):

* ``tc``: the width of the 64 x BN block tile and the number of TMA
  stages, ``(bn, stages)`` (a lifted tower: its inner ring's);
* ``skinny``: threads per block and a multiple of the columns per thread,
  ``(threads, cm)``;
* ``tower``: threads per block, rows and columns of C a thread,
  ``(threads, tc, cpt)``;
* ``simt`` keeps its static tile; its entry says so (``"static": true``).

The budget is the card's: at most 227 KB of dynamic shared memory a block
(a ``tc`` stage holds (64 + BN) * D * L * 64 bytes) and at most 255
registers a thread, with one block's registers within the SM's 65,536
(a ``tc`` consumer thread may hold 232: ``setmaxnreg``).
Each candidate is timed on the card from a CUDA graph of launches (CUDA
events around the replays, so the wrappers' host time stays out) and held
against the plain version bit for bit (batch slice 0) and against the
default configuration (every slice).  Winners persist to a committed JSON
cache (``autotune_cache.json`` beside this file), keyed by

    cuda|<torch.cuda.get_device_name()>|<route>|<d0>x<d1>e<e>|<T>x<R>x<S>

with an in-process LRU on top.  ``ops.pick_blocks`` consults it whenever a
caller pins no configuration; a miss runs the route's default, which is the
reference's documented semantics.  An entry naming a configuration the
library lacks is refused when the cache loads: a launch never swaps one
configuration for another in silence.

CLI (timing needs the card; ``--check`` runs anywhere):

    python -m repro_torch.kernels.autotune --budget 4        # retune DEFAULT_POINTS
    python -m repro_torch.kernels.autotune --check           # validate the committed cache
    python -m repro_torch.kernels.autotune --out build/autotune_cache.json

Determinism: candidate enumeration is a pure function of the key (sorted,
no RNG), so two runs disagree only through timing noise; each entry keeps
every candidate's time, registers and spills for inspection.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import device_kind
from .build import BUILD_DIR
from .gr_matmul import (
    MAX_D,
    SIMT_WIDE_TOWERS,
    SMEM_BLOCK_BYTES,
    kernel_tile,
    simt_grid,
    simt_thin,
    skinny_block,
    skinny_cols,
    skinny_configs,
    skinny_smem_bytes,
    tc_configs,
    tc_smem_bytes,
    tc_tile,
    tower_configs,
    tower_shape,
)
from .ref import n_limbs, tc_view

__all__ = [
    "CACHE_PATH",
    "CACHE_VERSION",
    "DEFAULT_POINTS",
    "REGISTER_BUDGET",
    "SMEM_BUDGET_BYTES",
    "TUNED_ROUTES",
    "TuneResult",
    "autotune",
    "cached_blocks",
    "candidate_blocks",
    "config_name",
    "coverage_gaps",
    "device_kind",
    "fits_budget",
    "invalidate_memory_cache",
    "load_cache",
    "ptxas_usage",
    "save_cache",
    "tune_key",
]

CACHE_PATH = Path(__file__).with_name("autotune_cache.json")
CACHE_VERSION = 1
TUNED_ROUTES = ("tc", "skinny", "tower")
SMEM_BUDGET_BYTES = SMEM_BLOCK_BYTES
REGISTER_BUDGET = 255  # a thread
REGISTER_FILE = 65536  # an SM, so one block's threads x registers
# a tc consumer warpgroup's registers a thread after setmaxnreg (the
# producer keeps 40: 128 * 40 + 256 * 232 = 384 * 168), and what it needs
# beyond its accumulators: two A fragments (8) and addresses, loop state
TC_CONSUMER_REGS = 232
_TC_REG_OVERHEAD = 32

_LRU_SIZE = 256
_LRU: "OrderedDict[str, Optional[tuple]]" = OrderedDict()
_DISK: Optional[Dict[str, dict]] = None  # lazily-loaded committed cache


def _route_of(ring, t: int, r: int, s: int, route: Optional[str]) -> str:
    if route is not None:
        return route
    from .ops import pick_route

    return pick_route(ring, t, r, s)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tune_key(ring, t: int, r: int, s: int, device=None, *, route: Optional[str] = None) -> str:
    """Canonical cache key: device | route | tower and e | aligned dims.

    ``tc`` and ``simt`` dims are rounded up to 8 so ragged shapes inside one
    tile share an entry; ``skinny``'s and ``tower``'s t and r (at most 64
    and 32) stay exact and only s is rounded.  ``route`` None: the one ``ops.pick_route`` takes.
    """
    dev = device_kind(device)
    route = _route_of(ring, t, r, s, route)
    d0, d1 = tower_shape(ring)
    if route in ("skinny", "tower"):
        T, R = t, r
    else:
        T, R = _round_up(t, 8), _round_up(r, 8)
    return f"{dev}|{route}|{d0}x{d1}e{ring.e}|{T}x{R}x{_round_up(s, 8)}"


def config_name(route: str, config) -> str:
    """Short name of a configuration: ``n32s3`` (tc), ``t128m1`` (skinny),
    ``t256r2c2`` (tower), ``b64x64k16`` (simt's static tile)."""
    c = tuple(config)
    if route == "tc":
        return "n{}s{}".format(*c)
    if route == "skinny":
        return "t{}m{}".format(*c)
    if route == "tower":
        return "t{}r{}c{}".format(*c)
    return "b{}x{}k{}".format(*c)


def _tower_K(d0: int, d1: int) -> int:
    return (2 * d0 - 1) * (2 * d1 - 1)


def _tc_register_estimate(ring, config) -> int:
    """Registers a tc consumer thread needs: its warpgroup's share of the
    tile's K0 * L accumulators (K0 = 2 D0 - 1 of the ring the main kernel
    runs over), ceil(K0 * L / 2) of them, BN / 2 words each a thread, plus
    the A fragments and ptxas' overhead."""
    pairs = -(-(2 * tc_view(*tower_shape(ring))[0] - 1) * n_limbs(ring) // 2)
    return pairs * config[0] // 2 + _TC_REG_OVERHEAD


def fits_budget(route: str, ring, config) -> bool:
    """Does ``config`` of ``route`` fit the card's budget for ``ring``:
    its shared memory at most 227 KB a block, and its registers within a
    thread's share of the SM's register file (tc: a consumer's 232 after
    ``setmaxnreg``; registers beyond a thread's limit spill, which ptxas
    reports; they do not stop a launch)."""
    d0, d1 = tower_shape(ring)
    if route == "tc":
        return (tc_smem_bytes(ring, config) <= SMEM_BUDGET_BYTES
                and _tc_register_estimate(ring, config) <= TC_CONSUMER_REGS)
    if route == "skinny":
        threads, cm = config
        cols = skinny_cols(d0, d1) or 0
        regs = _tower_K(d0, d1) * cols * cm + cols * cm * ring.D + 32
        return threads * min(regs, REGISTER_BUDGET) <= REGISTER_FILE and regs <= REGISTER_BUDGET
    if route == "tower":
        # tc x cpt x D accumulators and cpt x D words of B a thread
        threads, rows, cols = config
        regs = (rows + 1) * cols * ring.D + 32
        return threads * regs <= REGISTER_FILE and regs <= REGISTER_BUDGET
    return True


def _instantiated(route: str, d0: int, d1: int) -> tuple:
    if route == "tc":
        return tc_configs(d0, d1)
    if route == "skinny":
        return skinny_configs(d0, d1)
    if route == "tower":
        return tower_configs(d0, d1)
    raise ValueError(f"route {route!r} is not tuned")


def candidate_blocks(ring, t: int, r: int, s: int, *, route: Optional[str] = None) -> List[tuple]:
    """Deterministic candidate configurations of one tuning point.

    The route's instantiations for the ring's tower that fit the budget
    (:func:`fits_budget`), the default first, the rest by padding waste at
    this shape (tc), then larger tiles first, then the tuple: a bounded
    ``--budget`` prefix still holds the default and the likeliest winners.
    ``simt`` has one candidate, its static tile.
    """
    route = _route_of(ring, t, r, s, route)
    if route == "simt":
        return [kernel_tile(ring)]
    d0, d1 = tower_shape(ring)
    inst = _instantiated(route, d0, d1)
    if not inst:
        return []
    # skinny: a block's A and slab of B must fit its shared memory at (t, r)
    fits = lambda c: fits_budget(route, ring, c) and (  # noqa: E731
        route != "skinny" or skinny_smem_bytes(ring, t, r, c) <= SMEM_BUDGET_BYTES)
    default, rest = inst[0], [c for c in inst[1:] if fits(c)]

    def order(c):
        if route == "tc":
            bm, bn = tc_tile(c)
            waste = (-(-t // bm) * bm) * (-(-s // bn) * bn) / (max(t, 1) * max(s, 1))
            return (waste, -(bm * bn), c)
        return (0.0, -(c[0] * c[1]), c)

    return [default] + sorted(rest, key=order)


@dataclass(frozen=True)
class TuneResult:
    key: str
    route: str
    blocks: tuple  # the winning configuration
    ms: float
    default_ms: float
    tried: int  # candidates timed under the budget
    entry: dict  # what the cache records


def _valid_config(route: str, tower: Tuple[int, int], config) -> bool:
    d0, d1 = tower
    if route == "simt":
        if not (d0 * d1 <= MAX_D or tower in SIMT_WIDE_TOWERS):
            return False

        # kernel_tile reads the ring's D and K only
        return tuple(config) == kernel_tile(SimpleNamespace(D=d0 * d1, K=_tower_K(d0, d1)))
    return tuple(config) in _instantiated(route, d0, d1)


_KEY = re.compile(r"^[^|]+(?:\|[^|]+)?\|(tc|skinny|simt|tower)\|(\d+)x(\d+)e(\d+)\|(\d+)x(\d+)x(\d+)$")


def load_cache(path: Optional[Path] = None) -> Dict[str, dict]:
    """Deserialize the persisted cache ({key: entry}).

    A file of another ``CACHE_VERSION`` reads as empty (stale, not wrong);
    a malformed key or entry, or one naming a configuration the library
    is not built with (the instantiations ``gr_matmul`` mirrors), raises
    ValueError.
    """
    p = Path(path) if path else CACHE_PATH
    if not p.exists():
        return {}
    with open(p) as f:
        payload = json.load(f)
    if payload.get("version") != CACHE_VERSION:
        return {}
    entries = payload.get("entries", {})
    for key, e in entries.items():
        m = _KEY.match(key)
        if m is None or not isinstance(e, dict) or e.get("route") != m.group(1):
            raise ValueError(f"autotune cache entry {key!r} is malformed: {e}")
        cfg = e.get("config")
        if (not isinstance(cfg, list) or not cfg
                or not all(isinstance(b, int) and not isinstance(b, bool) and b > 0 for b in cfg)):
            raise ValueError(f"autotune cache entry {key!r} is malformed: {e}")
        tower = (int(m.group(2)), int(m.group(3)))
        if not _valid_config(e["route"], tower, cfg):
            raise ValueError(f"autotune cache entry {key!r} names {e['route']} {cfg}, which the "
                             f"kernel library has no instantiation of for tower {tower}")
    return entries


def _cache_meta(path: Optional[Path] = None) -> dict:
    p = Path(path) if path else CACHE_PATH
    if not p.exists():
        return {}
    with open(p) as f:
        return json.load(f).get("meta", {})


def save_cache(entries: Dict[str, dict], path: Optional[Path] = None,
               meta: Optional[dict] = None) -> Path:
    """Write ``entries`` (and ``meta``: the card's name and power limit)."""
    p = Path(path) if path else CACHE_PATH
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump({"version": CACHE_VERSION, "meta": meta or {}, "entries": entries},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    return p


def _disk_cache() -> Dict[str, dict]:
    global _DISK
    if _DISK is None:
        _DISK = load_cache()
    return _DISK


def invalidate_memory_cache() -> None:
    """Drop the in-process views (tests, or after rewriting the JSON)."""
    global _DISK
    _DISK = None
    _LRU.clear()


def cached_blocks(ring, t: int, r: int, s: int, device=None, *,
                  route: Optional[str] = None) -> Optional[tuple]:
    """The tuned configuration of this point, or None (the caller runs the
    route's default).  LRU over the deserialized committed cache: the hot
    path never re-reads JSON."""
    key = tune_key(ring, t, r, s, device, route=route)
    if key in _LRU:
        _LRU.move_to_end(key)
        return _LRU[key]
    entry = _disk_cache().get(key)
    blocks = tuple(entry["config"]) if entry is not None else None
    while len(_LRU) >= _LRU_SIZE:
        _LRU.popitem(last=False)
    _LRU[key] = blocks
    return blocks


# ptxas entry names -> route; the template arguments follow as Li<n>E
# (simt: d0, d1; simt_thin: D, rc, nn, wm, wn; tc: d0, d1, bn, stages, L;
# skinny: d0, d1, threads, cm, row groups; tower: d0, d1, threads, tc, cpt)
_ENTRY = re.compile(r"Compiling entry function '.*?(gr_matmul_kernel|simt_thin_kernel|"
                    r"gr_matmul_tc_kernel|gr_matmul_tc_left_kernel|gr_matmul_skinny_kernel|"
                    r"gr_matmul_tower_kernel|limbs_rows_kernel|limbs_cols_kernel|lift_cols_kernel|"
                    r"stack_cols_kernel|left_lift_kernel)(?:I((?:Li\d+E)+)|E)")
_ROUTE_OF = {"gr_matmul_kernel": "simt", "simt_thin_kernel": "simt_thin",
             "gr_matmul_tc_kernel": "tc",
             "gr_matmul_tc_left_kernel": "tc_left",
             "gr_matmul_skinny_kernel": "skinny", "gr_matmul_tower_kernel": "tower",
             "limbs_rows_kernel": "limbs_rows", "limbs_cols_kernel": "limbs_cols",
             "lift_cols_kernel": "lift", "stack_cols_kernel": "stack",
             "left_lift_kernel": "left_lift"}


def ptxas_usage(build_dir: Path = BUILD_DIR) -> Dict[str, dict]:
    """Registers and spill bytes per instantiation, from the ``-Xptxas -v``
    output the build keeps as ``<source>.ptxas.txt``: keys are
    ``route(template arguments)``, e.g. ``tc(3,1,32,3,4)``."""
    from .build import SOURCES

    usage: Dict[str, dict] = {}
    for name in SOURCES:
        ptxas = Path(build_dir) / f"{name}.ptxas.txt"
        cur = None
        for line in ptxas.read_text().splitlines() if ptxas.exists() else []:
            m = _ENTRY.search(line)
            if m:
                args = ",".join(re.findall(r"Li(\d+)E", m.group(2) or ""))
                cur = f"{_ROUTE_OF[m.group(1)]}({args})"
                usage[cur] = {}
            elif cur:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    usage[cur]["spill_st"], usage[cur]["spill_ld"] = int(m.group(1)), int(m.group(2))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    usage[cur]["regs"] = int(m.group(1))
    return usage


def _usage_of(usage: dict, route: str, ring, config, t: int = 1, r: int = 1) -> dict:
    tower = tower_shape(ring)
    if route == "simt" and simt_thin(ring, t):  # the thin kernel's (D, rc, nn, wm, wn)
        route, args = "simt_thin", (ring.D, *simt_grid(ring, 1, t, r, 1, 1)[5:9])
    elif route == "simt":  # the tile kernel: one per tower
        args = tuple(tower)
    elif route == "tc":  # the main kernel of the ring, or of a lifted tower's inner ring
        args = (tc_view(*tower)[0], 1, *config, n_limbs(ring))
    elif route == "skinny":  # the kernel that splits C's rows among groups, or not
        args = (*tower, *config, skinny_block(ring, t, r, config)[1])
    else:
        args = (*tower, *config)
    return usage.get(f"{route}({','.join(map(str, args))})", {})


def _graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph of ``iters``
    calls, from CUDA events around three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as graphs require
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def _operands(ring, batch: int, t: int, r: int, s: int, device):
    from ..core.galois import from_numpy

    rng = np.random.default_rng(0)
    bound = 1 << ring.e if ring.e < 32 else 1 << 32
    A = rng.integers(0, bound, size=(batch, t, r, ring.D), dtype=np.uint64).astype(np.uint32)
    B = rng.integers(0, bound, size=(batch, r, s, ring.D), dtype=np.uint64).astype(np.uint32)
    return from_numpy(A, ring, device), from_numpy(B, ring, device)


def autotune(
    ring,
    t: int,
    r: int,
    s: int,
    *,
    batch: int = 1,
    route: Optional[str] = None,
    budget: Optional[int] = None,
    iters: int = 10,
    device=None,
    persist: bool = False,
    path: Optional[Path] = None,
) -> TuneResult:
    """Time the candidates of one point on the card and record the winner
    (``simt``: its static tile, timed and marked ``"static": true``).

    ``budget`` caps how many candidates are timed (the deterministic order
    keeps the default first); ``persist`` writes the cache JSON back
    (default: in-process only).  Every candidate's output is held against
    the plain version (batch slice 0) and the default's (all slices) bit
    for bit; a mismatch raises RuntimeError.  Raises ValueError off the
    card or outside the kernels' envelope.
    """
    from .ops import kernel_supported, run_route
    from .ref import gr_matmul_ref

    if ring.p != 2 or ring.e > 32 or not kernel_supported(ring):
        raise ValueError(f"{ring} is outside the kernel envelope")
    route = _route_of(ring, t, r, s, route)
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise ValueError("autotune times the kernels on the card; there is none here")
    key = tune_key(ring, t, r, s, dev, route=route)
    cands = candidate_blocks(ring, t, r, s, route=route)
    if budget is not None:
        cands = cands[: max(1, budget)]
    A, B = _operands(ring, batch, t, r, s, dev)
    want = gr_matmul_ref(A[:1], B[:1], ring)
    usage = ptxas_usage()
    times: Dict[str, float] = {}
    first = None
    for cfg in cands:
        out = run_route(route, A, B, ring, cfg)
        torch.cuda.synchronize()
        if not torch.equal(out[:1], want) or (first is not None and not torch.equal(out, first)):
            raise RuntimeError(f"{key}: {route} {cfg} disagrees with the plain version")
        if first is None:
            first = out
        del out
        times[config_name(route, cfg)] = _graph_ms(lambda c=cfg: run_route(route, A, B, ring, c),
                                                   iters)
    names = {config_name(route, c): c for c in cands}
    best = min(times, key=lambda n: (times[n], n))
    default_name = config_name(route, cands[0])
    entry = {
        "route": route, "config": list(names[best]), "name": best, "ms": times[best],
        "default": default_name, "default_ms": times[default_name], "batch": batch,
        "tried": len(cands), "candidates": times,
        "usage": {n: _usage_of(usage, route, ring, c, t, r) for n, c in names.items()},
        "checked": "plain version (batch slice 0) and the default (all slices), bit for bit",
    }
    if route not in TUNED_ROUTES:
        entry["static"] = True  # simt has one instantiation a tower
    entries = dict(_disk_cache())
    entries[key] = entry
    global _DISK
    _DISK = entries
    _LRU.pop(key, None)
    if persist:
        save_cache(entries, path, meta=_card_meta(dev))
    del A, B, want, first
    torch.cuda.empty_cache()
    return TuneResult(key, route, names[best], times[best], times[default_name], len(cands), entry)


def _card_meta(device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    idx = torch.device(device).index or 0
    return {"device": device_kind(device), "nvidia_smi": smi[idx] if idx < len(smi) else smi[0],
            "timing": "CUDA events around CUDA-graph replays"}


# ---------------------------------------------------------------------------
# CLI: retune / verify the committed cache
# ---------------------------------------------------------------------------

# (route, ring constructor args, batch, (t, r, s)): the tc and skinny calls
# of the port's main path (batch_ep_rmfe n = 2 at 2048^3 over Z_2^32: phi,
# psi, the encodes and the decode over GR(2^32, 3), the worker products, a
# worker's own encode), of its secure and GCSA paths over GR(2^32, 4)
# (gcsa, ep_rmfe_secure at 2048^3; gcsa_general, ep_secure at 1024^3) and
# of CodedQuantMatmul at gemma2-2b's FFN (N = 16); ElasticStream's step
# over the (3, 7) tower (the worker products on tc, lifted; the two encodes
# and the decode on tower); the planner's wider rings that chip_smoke.py
# drives (batch_ep_rmfe n = 4 over the (3, 4) tower and n = 2 for 64
# workers over GR(2^32, 6) at 2048^3, ep_secure for 16 workers over
# GR(2^32, 5) at 1024^3: the worker products on tc, lifted, the 64-row
# encodes and the 32 x 32 decode on skinny); and simt's static tile at
# ep's 48-row worker blocks at 96^3 and at the (3, 7) worker shape, its
# yardstick there
DEFAULT_POINTS: Tuple[Tuple[str, Tuple[int, int, Tuple[int, ...]], int, Tuple[int, int, int]], ...] = (
    ("simt", (2, 32, (3,)), 8, (48, 96, 48)),
    ("simt", (2, 32, (3, 7)), 8, (512, 1024, 256)),
    ("tc", (2, 32, (3,)), 8, (1024, 2048, 1024)),
    ("tc", (2, 32, (4,)), 8, (2048, 2048, 2048)),
    ("tc", (2, 32, (4,)), 8, (2048, 2048, 1024)),
    ("tc", (2, 32, (4,)), 8, (1024, 2048, 1024)),
    ("tc", (2, 32, (4,)), 8, (1024, 1024, 512)),
    ("tc", (2, 32, (4,)), 16, (1024, 1152, 4608)),
    ("tc", (2, 32, (3, 7)), 8, (512, 1024, 256)),
    ("skinny", (2, 32, ()), 1, (2, 2, 4194304)),
    ("skinny", (2, 32, ()), 1, (2, 3, 4194304)),
    ("skinny", (2, 32, (3,)), 1, (8, 2, 2097152)),
    ("skinny", (2, 32, (3,)), 1, (4, 4, 1048576)),
    ("skinny", (2, 32, (3,)), 1, (1, 2, 2097152)),
    ("skinny", (2, 32, (4,)), 1, (8, 2, 4194304)),
    ("skinny", (2, 32, (4,)), 1, (8, 3, 2097152)),
    ("skinny", (2, 32, (4,)), 1, (2, 5, 2097152)),
    ("skinny", (2, 32, (4,)), 1, (16, 2, 5308416)),
    ("skinny", (2, 32, (4,)), 1, (4, 4, 4718592)),
    ("tower", (2, 32, (3, 7)), 1, (8, 2, 524288)),
    ("tower", (2, 32, (3, 7)), 1, (8, 4, 262144)),
    ("tower", (2, 32, (3, 7)), 1, (8, 8, 131072)),
    ("tc", (2, 32, (3, 4)), 16, (1024, 2048, 512)),
    ("tc", (2, 32, (6,)), 64, (512, 2048, 256)),
    ("tc", (2, 32, (5,)), 16, (512, 1024, 512)),
    ("skinny", (2, 32, (6,)), 1, (64, 4, 1048576)),
    ("skinny", (2, 32, (6,)), 1, (64, 8, 524288)),
    ("skinny", (2, 32, (6,)), 1, (32, 32, 131072)),
)


def coverage_gaps(entries: Dict[str, dict], points: Sequence = DEFAULT_POINTS,
                  device=None) -> List[str]:
    """Keys of ``points`` missing from ``entries`` (empty: full cover)."""
    from ..core.galois import make_ring

    missing = []
    for route, (p, e, degrees), _, (t, r, s) in points:
        key = tune_key(make_ring(p, e, tuple(degrees)), t, r, s, device, route=route)
        if key not in entries:
            missing.append(key)
    return missing


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", type=int, default=None,
                    help="max candidates timed per point (default: all of them)")
    ap.add_argument("--iters", type=int, default=10, help="launches per CUDA graph")
    ap.add_argument("--out", default=None, help=f"cache path to write (default {CACHE_PATH})")
    ap.add_argument("--check", action="store_true",
                    help="do not retune: verify the cache deserializes and covers DEFAULT_POINTS")
    ap.add_argument("--device", default=None,
                    help="device kind whose coverage --check verifies (default: this machine's, "
                         "e.g. 'cuda|NVIDIA H100 80GB HBM3')")
    args = ap.parse_args(argv)

    if args.check:
        entries = load_cache(args.out)  # raises on malformed entries
        kind = args.device or device_kind()
        gaps = coverage_gaps(entries, device=kind)
        print(f"cache OK: {len(entries)} entries at {args.out or CACHE_PATH} "
              f"({_cache_meta(args.out).get('nvidia_smi', 'no card named')})")
        if gaps:
            print("MISSING coverage:")
            for k in gaps:
                print(f"  {k}")
            return 1
        print(f"covers all {len(DEFAULT_POINTS)} default points on device={kind!r}")
        return 0

    from ..core.galois import make_ring

    global _DISK
    _DISK = load_cache(args.out) if args.out and Path(args.out).exists() else dict(_disk_cache())
    for route, (p, e, degrees), batch, (t, r, s) in DEFAULT_POINTS:
        ring = make_ring(p, e, tuple(degrees))
        res = autotune(ring, t, r, s, batch=batch, route=route, budget=args.budget,
                       iters=args.iters)
        print(f"{res.key}: {config_name(route, res.blocks)} {res.ms:.4f} ms "
              f"(default {res.entry['default']} {res.default_ms:.4f} ms; tried {res.tried})")
    out = save_cache(_disk_cache(), args.out, meta=_card_meta("cuda"))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
