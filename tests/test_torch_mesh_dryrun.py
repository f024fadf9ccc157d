"""repro_torch's dry-run (``launch.dryrun``, ``launch.steps.lower_cell``,
``launch.comm_analysis``, ``launch.roofline``) on a smoke config over a
fake 8-rank (2, 2, 2) group, in a subprocess (the fake default group never
enters the pytest process).

A cell's record must be ``ok``; the parameters' bytes a device must be the
sum of the local shards ``spec_for`` predicts; the MoE cells must record
collectives (the islands' all-to-all for prefill, the psums for decode);
``roofline.table`` must format the records.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch import roofline
from repro_torch.launch.steps import build_cell, rules_for
from repro_torch.runtime import sharding as TS

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "qwen3-moe-30b-a3b"
KINDS = ("prefill", "decode")
SEQ, BATCH = 64, 4  # the batch divides the (pod, data) axes: the MoE takes its islands

RUN = """
import sys
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch.dryrun import fake_group, run_cell
from repro_torch.launch.mesh import make_debug_mesh
fake_group(8)
mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
for kind in sys.argv[3:]:
    run_cell(sys.argv[2], kind, "debug", force=True, mesh=mesh, art_dir=sys.argv[1],
             cfg=ARCHS[sys.argv[2]].smoke(), shape=ShapeConfig(kind, %d, %d, kind))
""" % (SEQ, BATCH)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    art = tmp_path_factory.mktemp("dryrun_torch")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    res = subprocess.run([sys.executable, "-c", RUN, str(art), ARCH, *KINDS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return art, {k: json.loads((art / f"{ARCH}__{k}__debug.json").read_text()) for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_cell_ok_and_param_bytes_match_spec_for(records, kind):
    rec = records[1][kind]
    assert rec["status"] == "ok", rec.get("error")
    cfg, shape = ARCHS[ARCH].smoke(), ShapeConfig(kind, SEQ, BATCH, kind)
    rules = {**TS.DEFAULT_RULES, **rules_for(cfg, shape)}
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
    want = 0
    for _, ps in TS._leaf_paths(build_cell(cfg, shape).api.param_specs):
        spec = TS.spec_for(ps.shape, ps.logical, mesh, rules)
        want += int(np.prod(TS.local_shape(ps.shape, spec, mesh))) * ps.dtype.itemsize
    assert rec["param_bytes_per_device"] == want
    assert rec["param_bytes"] == TS.param_bytes(build_cell(cfg, shape).api.param_specs)
    assert rec["chips"] == 8 and rec["mesh_shape"] == {"pod": 2, "data": 2, "model": 2}
    mem = rec["memory"]
    assert rec["bytes_per_device"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert mem["argument_size_in_bytes"] >= want
    assert rec["fits_hbm"] is True


@pytest.mark.parametrize("kind", KINDS)
def test_cell_records_collectives_and_roofline(records, kind):
    rec = records[1][kind]
    coll = rec["collectives"]
    assert coll["count"] > 0 and sum(v for k, v in coll.items() if k != "count") > 0
    if kind == "prefill":  # seq 64 % 16 == 0: residual_seq = model, the a2a island
        assert rec["collective_counts"].get("all-to-all", 0) > 0
    else:  # the shardmap island's psums
        assert rec["collective_counts"].get("all-reduce", 0) > 0
    t = rec["roofline"]
    assert t["collective_bytes_per_chip"] == sum(v for k, v in coll.items() if k != "count")
    assert t["hlo_flops_per_chip_raw"] > 0 and t["hlo_bytes_per_chip_raw"] > 0
    assert t["dominant"] in ("compute", "memory", "collective")
    assert rec["device"] == "NVIDIA H100 80GB HBM3, 700 W"


def test_roofline_table_formats(records):
    art, recs = records
    text = roofline.table("debug", art_dir=str(art))
    rows = text.splitlines()
    assert rows[0].startswith("| arch | shape |") and len(rows) == 2 + len(KINDS)
    for kind in KINDS:
        assert roofline.fmt_row(recs[kind]) in rows
        assert f"| {ARCH} | {kind} |" in roofline.fmt_row(recs[kind])
