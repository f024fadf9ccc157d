"""repro_torch.kernels.autotune on the CPU, mirroring tests/test_autotune.py:
the cache's round trip and its refusals (malformed, stale, uninstantiated),
deterministic candidates inside the card's shared-memory and register
budget, ``ops.pick_blocks`` / ``run_route`` consulting the cache (an
explicit configuration wins), the LRU across invalidation, the committed
cache covering ``DEFAULT_POINTS``, and the envelope.  The timing itself
needs the card (tests/test_torch_card.py, chip_smoke.py phase 10)."""
import json

import pytest
import torch

from repro_torch.core import make_ring
from repro_torch.device import device_kind
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops
from repro_torch.kernels.gr_matmul import (
    SKINNY_CONFIGS,
    TC_CONFIGS,
    skinny_configs,
    tc_configs,
    tc_smem_bytes,
)

GR3 = make_ring(2, 32, (3,))
GR4 = make_ring(2, 32, (4,))
Z32 = make_ring(2, 32, ())
DEV = "cuda|Test Card"


@pytest.fixture(autouse=True)
def fresh_memory_cache():
    """Each test sees the committed cache afresh and leaks nothing
    in-process (tests inject entries into the in-memory view only)."""
    at.invalidate_memory_cache()
    yield
    at.invalidate_memory_cache()


def _entry(route, config):
    return {"route": route, "config": list(config), "ms": 1.0}


def _inject(key, entry):
    """An entry in the in-process view, as ``autotune`` records one."""
    at._disk_cache()[key] = entry
    at._LRU.pop(key, None)


# ------------------------------------------------------------- cache I/O


def test_cache_roundtrip(tmp_path):
    entries = {
        at.tune_key(GR3, 1024, 2048, 1024, DEV, route="tc"): _entry("tc", (32, 2)),
        at.tune_key(GR4, 4, 4, 4718592, DEV, route="skinny"): _entry("skinny", (256, 1)),
        at.tune_key(Z32, 8, 8, 8, DEV, route="simt"): _entry("simt", at.kernel_tile(Z32)),
    }
    path = tmp_path / "cache.json"
    at.save_cache(entries, path, meta={"nvidia_smi": "Test Card, 700.00 W"})
    payload = json.loads(path.read_text())
    assert payload["version"] == at.CACHE_VERSION and payload["meta"]["nvidia_smi"]
    assert at.load_cache(path) == payload["entries"] == entries


@pytest.mark.parametrize("key,entry,match", [
    ("cuda|X|tc|3x1e32", _entry("tc", (32, 3)), "malformed"),          # no dims
    (f"{DEV}|tc|3x1e32|8x8x8", _entry("skinny", (128, 1)), "malformed"),  # route != key's
    (f"{DEV}|tc|3x1e32|8x8x8", {"route": "tc", "config": [32]}, "no instantiation"),
    (f"{DEV}|tc|3x1e32|8x8x8", {"route": "tc", "config": "n32s3"}, "malformed"),
    (f"{DEV}|tc|3x1e32|8x8x8", {"route": "tc", "config": [32, 0]}, "malformed"),
    (f"{DEV}|tc|3x1e32|8x8x8", _entry("tc", (2, 4, 3)), "no instantiation"),  # mma.sync's w2x4s3
    (f"{DEV}|tc|5x1e32|8x8x8", _entry("tc", (32, 3)), "no instantiation"),
    (f"{DEV}|skinny|5x1e32|8x8x8", _entry("skinny", (256, 1)), "no instantiation"),
    (f"{DEV}|simt|3x1e32|8x8x8", _entry("simt", (16, 16, 16)), "no instantiation"),
], ids=["no-dims", "route", "short", "not-a-list", "zero", "tc-uninstantiated",
        "tc-tower", "skinny-extra-on-D5", "simt-tile"])
def test_cache_load_rejects_malformed_entries(tmp_path, key, entry, match):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": at.CACHE_VERSION, "entries": {key: entry}}))
    with pytest.raises(ValueError, match=match):
        at.load_cache(path)


def test_cache_version_mismatch_is_empty(tmp_path):
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"version": 999, "entries": {"k": {}}}))
    assert at.load_cache(path) == {}
    assert at.load_cache(tmp_path / "missing.json") == {}


def test_committed_cache_deserializes_and_covers_default_points():
    """The committed JSON loads, was measured on a card it names, and
    covers every default point for that card (``--check``)."""
    entries = at.load_cache()
    assert entries, "the committed autotune cache is missing or empty"
    kinds = {key.rsplit("|", 3)[0] for key in entries}
    assert all(k.startswith("cuda|") for k in kinds), kinds
    assert any(not at.coverage_gaps(entries, device=k) for k in kinds), kinds
    meta = at._cache_meta()
    assert meta["device"] in kinds and meta["nvidia_smi"].startswith(meta["device"][5:])
    for key, e in entries.items():
        assert e["default"] in e["candidates"] and set(e["usage"]) == set(e["candidates"])
        assert e["ms"] == min(e["candidates"].values())
        # simt keeps its static tile, and its entry says so
        assert (e["route"] in at.TUNED_ROUTES) != bool(e.get("static")), key
    kind = sorted(kinds)[0]
    assert at.main(["--check", "--device", kind]) == 0
    assert at.main(["--check", "--device", "cpu"]) == 1  # card entries only


# ------------------------------------------------- candidate enumeration


def test_candidate_enumeration_is_deterministic():
    for ring in (Z32, GR3, GR4):
        a = at.candidate_blocks(ring, 1024, 2048, 1024, route="tc")
        assert a == at.candidate_blocks(ring, 1024, 2048, 1024, route="tc")
        assert len(a) == len(set(a)) and set(a) <= set(tc_configs(ring.D, 1))
    assert at.candidate_blocks(GR3, 8, 2, 2097152) == at.candidate_blocks(GR3, 8, 2, 2097152)
    assert at.candidate_blocks(GR3, 48, 48, 48) == [at.kernel_tile(GR3)]  # simt: static


@pytest.mark.parametrize("tower", sorted(TC_CONFIGS), ids=str)
def test_candidates_include_static_default_and_respect_budget(tower):
    ring = make_ring(2, 32, (tower[0],) if tower[0] > 1 else ())
    cands = at.candidate_blocks(ring, 1024, 2048, 1024, route="tc")
    assert cands[0] == tc_configs(*tower)[0]
    assert set(cands) == set(tc_configs(*tower))  # every instantiation fits at L = 4
    for config in cands:
        assert tc_smem_bytes(ring, config) <= at.SMEM_BUDGET_BYTES == 227 * 1024
        assert at._tc_register_estimate(ring, config) <= at.TC_CONSUMER_REGS == 232
    skinny = at.candidate_blocks(ring, 8, 2, 2097152, route="skinny")
    assert skinny[0] == (128, 1) and set(skinny) == set(SKINNY_CONFIGS[tower])
    # the reckoning: a stage holds (64 + BN) * D * L * 64 bytes, so at D = 4
    # and L = 4 a 64 x 24 tile (90,112 B a stage) fits two stages, not
    # three; one fewer limb (L = 3) fits three
    if tower == (4, 1):
        assert tc_smem_bytes(GR4, (24, 1)) == 1024 + 90112 + 16
        assert at.fits_budget("tc", GR4, (24, 2)) and not at.fits_budget("tc", GR4, (24, 3))
        assert at.fits_budget("tc", make_ring(2, 24, (4,)), (24, 3))  # L = 3
    # the accumulators, not the tile, bound BN: a consumer holds
    # ceil(K * L / 2) * BN / 2 of them, so BN = 32 is too wide at D = 4
    assert at.fits_budget("tc", ring, (32, 2)) == (tower != (4, 1))


def test_tune_key_canonicalizes_ragged_shapes():
    assert at.tune_key(GR3, 1020, 2045, 1017, DEV) == at.tune_key(GR3, 1024, 2048, 1024, DEV)
    assert at.tune_key(GR3, 1024, 2048, 1024, DEV) == f"{DEV}|tc|3x1e32|1024x2048x1024"
    # skinny keeps t and r: phi (2 x 2) and psi (2 x 3) stay apart
    assert at.tune_key(Z32, 2, 2, 4194304, DEV) != at.tune_key(Z32, 2, 3, 4194304, DEV)
    assert at.tune_key(Z32, 2, 3, 4194301, DEV) == f"{DEV}|skinny|1x1e32|2x3x4194304"
    assert at.tune_key(GR3, 8, 8, 8, DEV) != at.tune_key(make_ring(2, 16, (3,)), 8, 8, 8, DEV)
    # a CPU key never names a card, so it never picks a kernel configuration
    assert device_kind("cpu") == "cpu" and at.tune_key(GR3, 8, 8, 8, "cpu").startswith("cpu|")


# --------------------------------------------------- the cache in the ops


def test_ops_pick_the_cached_config(monkeypatch):
    assert ops.pick_blocks(GR3, 1024, 2048, 1024, device=DEV) == tc_configs(3, 1)[0]  # a miss
    _inject(at.tune_key(GR3, 1024, 2048, 1024, DEV), _entry("tc", (24, 3)))
    _inject(at.tune_key(GR3, 8, 2, 2097152, DEV), _entry("skinny", (256, 1)))
    assert ops.pick_blocks(GR3, 1024, 2048, 1024, device=DEV) == (24, 3)
    assert ops.pick_blocks(GR3, 8, 2, 2097152, device=DEV) == (256, 1)
    # simt: its static tile at t, the cache unread (48 rows: the thin kernel's)
    assert ops.pick_blocks(GR3, 48, 48, 48, device=DEV) == at.kernel_tile(GR3, 48) == (21, 32, 32)
    assert ops.pick_blocks(GR3, 1024, 2048, 1024, device="cpu") == tc_configs(3, 1)[0]
    # run_route hands the wrapper the cached configuration of its tensors'
    # device kind (here the CPU's, injected), or the one the caller pins
    seen = []
    monkeypatch.setattr(ops, "gr_matmul_tc", lambda A, B, ring, config: seen.append(config))
    _inject(at.tune_key(GR3, 64, 64, 64, "cpu"), _entry("tc", (32, 2)))
    A = torch.zeros((64, 64, 3), dtype=torch.int32)
    ops.run_route("tc", A, A, GR3)
    ops.run_route("tc", A, A, GR3, config=(24, 3))
    assert seen == [(32, 2), (24, 3)]


def test_explicit_config_overrides_cache(monkeypatch):
    _inject(at.tune_key(Z32, 8, 2, 4096, "cpu"), _entry("skinny", (128, 2)))
    seen = []
    monkeypatch.setattr(ops, "gr_matmul_skinny", lambda A, B, ring, config: seen.append(config))
    A, B = torch.zeros((8, 2, 1), dtype=torch.int32), torch.zeros((2, 4096, 1), dtype=torch.int32)
    for config in (None, (256, 1), (128, 1)):
        ops.run_route("skinny", A, B, Z32, config=config)
    assert seen == [(128, 2), (256, 1), (128, 1)]


def test_lru_survives_disk_invalidation_boundary():
    key = at.tune_key(GR4, 1024, 1024, 512, DEV)
    _inject(key, _entry("tc", (16, 2)))
    assert at.cached_blocks(GR4, 1024, 1024, 512, DEV) == (16, 2)
    at._DISK.pop(key)
    assert at.cached_blocks(GR4, 1024, 1024, 512, DEV) == (16, 2)  # an LRU hit
    at.invalidate_memory_cache()
    # nothing was persisted: the in-process entry is gone, the committed file rules
    assert at.cached_blocks(GR4, 1024, 1024, 512, DEV) is None


def test_lru_is_bounded():
    for t in range(at._LRU_SIZE + 8):
        at.cached_blocks(GR3, 64 + 8 * t, 64, 64, DEV)
    assert len(at._LRU) == at._LRU_SIZE
    assert at.tune_key(GR3, 64, 64, 64, DEV) not in at._LRU  # the oldest went first


def test_autotune_rejects_out_of_envelope_rings_and_the_cpu():
    with pytest.raises(ValueError, match="envelope"):
        at.autotune(make_ring(3, 2, (2,)), 8, 8, 8)
    with pytest.raises(ValueError, match="card"):
        at.autotune(GR3, 1024, 2048, 1024, device="cpu")
    with pytest.raises(ValueError, match="envelope"):
        at.autotune(make_ring(2, 32, (17,)), 1024, 2048, 1024)
    with pytest.raises(ValueError, match="card"):  # simt: its static tile, timed
        at.autotune(GR3, 48, 96, 48, device="cpu")


def test_ptxas_usage_reads_every_instantiation(tmp_path):
    (tmp_path / "gr_matmul_tc.ptxas.txt").write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gr_matmul_tc_kernelILi4ELi1E"
        "Li24ELi2ELi4EEEv14CUtensorMap_stS1_Pjiiii9FoldTablej' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1\n"
        "    0 bytes stack frame, 132 bytes spill stores, 104 bytes spill loads\n"
        "ptxas info    : Used 168 registers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123gr_matmul_skinny_kernelILi3ELi1E"
        "Li128ELi2EEEvPKjS2_Pjiii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 80 registers\n")
    usage = at.ptxas_usage(tmp_path)
    assert usage == {"tc(4,1,24,2,4)": {"spill_st": 132, "spill_ld": 104, "regs": 168},
                     "skinny(3,1,128,2)": {"spill_st": 0, "spill_ld": 0, "regs": 80}}
    # a tc entry names its instantiation at the ring's L (here 4)
    assert at._usage_of(usage, "tc", GR4, (24, 2))["regs"] == 168
    assert at._usage_of(usage, "tc", make_ring(2, 24, (4,)), (24, 2)) == {}
    simt = {"simt(3,7)": {"regs": 123}}
    assert at._usage_of(simt, "simt", make_ring(2, 32, (3, 7)), (16, 16, 16)) == {"regs": 123}
    assert at.config_name("tc", (32, 2)) == "n32s2" and at.config_name("skinny", (128, 2)) == "t128m2"
    # GR(2^32, 5): skinny's default only; tc lifted onto Z_2^32, its (1, 1) tiles
    assert skinny_configs(5, 1) == ((128, 1),) and tc_configs(5, 1) == TC_CONFIGS[(1, 1)]
    assert not tc_configs(5, 2)
