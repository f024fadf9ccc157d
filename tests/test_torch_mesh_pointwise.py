"""``runtime.sharding._agreeing_pointwise``: the layout it gives a pointwise
op whose operands' splits agree must be the one DTensor's own search
picks, and the local results the same bits.

Each case runs twice in a subprocess over a fake 8-rank (2, 2, 2) group
(the fake default group never enters the pytest process): once with
DTensor's own strategies, once with the shortcut installed.  Every operand
is built with ``DTensor.from_local`` from seeded local tensors, so the two
runs see the same inputs; the cases cover agreeing splits, a broadcast
dim, a replicated operand sliced locally, a scalar operand, an in-place
op, and cases the shortcut leaves to DTensor (a partial sum, an in-place
op that would change its own layout).
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

RUN = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
if sys.argv[1] == "agreeing":
    from repro_torch.runtime.sharding import _agreeing_pointwise
    _agreeing_pointwise()
R, S, P = Replicate(), Shard, Partial()
gen = torch.Generator().manual_seed(0)


def dt(shape, pl):
    local = list(shape)
    for m, q in enumerate(pl):
        if isinstance(q, Shard):
            local[q.dim] //= mesh.size(m)
    t = torch.randn(local, generator=gen)
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


cases = {
    "same": lambda: dt((2, 64, 4, 16), [S(0), R, S(1)]) + dt((2, 64, 4, 16), [S(0), R, S(1)]),
    "broadcast": lambda: dt((2, 64, 2, 16), [S(0), R, S(1)]) * dt((2, 64, 1, 16), [S(0), R, S(1)]),
    "sliced": lambda: dt((2, 2, 2, 64, 64), [S(0), S(1), S(3)]) + dt((2, 2, 2, 64, 64), [S(0), R, S(3)]),
    "lower_rank": lambda: dt((4, 8, 16), [S(0), S(1), R]) * dt((16,), [R, R, R]),
    "scalar": lambda: dt((4, 8, 16), [S(0), R, S(2)]) / torch.tensor(3.0),
    "unary": lambda: torch.exp(dt((4, 8, 16), [S(0), S(2), R])),
    "where": lambda: torch.where(dt((4, 8), [S(0), R, S(1)]) > 0, dt((4, 8), [S(0), R, S(1)]), 0.0),
    "inplace": lambda: dt((4, 8, 16), [S(0), R, S(2)]).mul_(dt((4, 8, 16), [S(0), R, S(2)])),
    "inplace_replicated_self": lambda: dt((4, 8, 16), [R, R, R]).add_(dt((4, 8, 16), [S(0), R, R])),
    "partial": lambda: dt((4, 8), [P, R, R]) + dt((4, 8), [S(0), R, R]),
}
out = {}
for name, fn in cases.items():
    y = fn()
    out[name] = {"placements": [str(q) for q in y.placements], "shape": list(y.shape),
                 "local": y.to_local().flatten().tolist()}
import torch.distributed.tensor._sharding_prop as sp
expand = getattr(sp, "_expand_single_dim_strategy_to_mesh", None)
out["installed"] = [expand is not None, getattr(expand, "agreeing_pointwise", False)]
print(json.dumps(out))
"""


def _run(mode):
    proc = subprocess.run([sys.executable, "-c", RUN, mode], capture_output=True, text=True,
                          timeout=240, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    return _run("dtensor"), _run("agreeing")


CASES = ["same", "broadcast", "sliced", "lower_rank", "scalar", "unary", "where", "inplace",
         "inplace_replicated_self", "partial"]


@pytest.mark.parametrize("case", CASES)
def test_agreeing_pointwise_matches_dtensor(runs, case):
    """Where this torch has the per-mesh-dim expansion, the shortcut is in
    place in the second run and absent from the first."""
    own, agreeing = runs
    assert own["installed"][1] is False
    assert agreeing["installed"][1] is agreeing["installed"][0]
    assert agreeing[case]["placements"] == own[case]["placements"]
    assert agreeing[case]["shape"] == own[case]["shape"]
    assert agreeing[case]["local"] == own[case]["local"]
