"""Multi-pod dry-run — counterpart of ``repro.launch.dryrun``: every
(arch x shape x mesh) cell's step run once on fake tensors.

For each cell it records what the reference records, where the port has a
counterpart:
  * ``memory``: the arguments' local-shard bytes and the temporaries' peak
    (``launch.steps.lower_cell``'s high-water of live bytes a rank), their
    sum ``bytes_per_device`` and ``fits_hbm`` against the H100's 80 GB;
    ``fits_hbm_basis`` says what that peak counts (eager tensors, no
    compiler's fusion: not XLA's ``memory_analysis``)
  * ``cost``: a rank's FLOPs and bytes accessed, counted op by op
  * ``collectives``: every collective the step issued, result bytes by kind
  * ``roofline``: ``comm_analysis.roofline_terms`` on the H100's constants
  * ``lower_s``: the fake run's seconds (there is no compile step)

It initializes a ``"fake"`` process group of 256 (single pod) or 512
(multi-pod) ranks in this one process, refuses to run when a real group is
up, and never allocates a parameter.  A cell that fails is recorded as
``"status": "error"`` with its reason.  Artifacts land in
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``REPRO_TORCH_DRYRUN_DIR``) and are read by ``launch.roofline``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi --force
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

from ..configs import ARCHS, SHAPES, cells
from ..runtime.sharding import mesh_sizes, param_bytes, param_count
from .comm_analysis import DEVICE, HBM_BYTES, collective_bytes, roofline_terms
from .costmodel import analytic_costs
from .mesh import PRODUCTION_SHAPES, make_debug_mesh
from .steps import build_cell, lower_cell

__all__ = ["ART_DIR", "fake_group", "main", "run_cell"]

ART_DIR = os.environ.get(
    "REPRO_TORCH_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch"),
)


# what ``fits_hbm`` weighs, written into every record
FITS_BASIS = ("eager peak of live tensors a rank: every temporary held from the op that "
              "makes it to its last use, nothing fused or rematerialized by a compiler; "
              "an upper bound beside XLA's memory_analysis, not comparable with it")


def fake_group(world: int) -> None:
    """Initialize the default process group as ``"fake"`` over ``world``
    ranks, this process rank 0 (every collective returns at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group; one is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False, mesh=None,
             art_dir: str = None, cfg=None, shape=None) -> dict:
    """Lower one cell on ``mesh`` (default: the production mesh of
    ``mesh_kind`` over the initialized fake group) and write its record;
    ``cfg``/``shape`` replace the named config and shape (a smoke cell)."""
    art_dir = art_dir or ART_DIR
    os.makedirs(art_dir, exist_ok=True)
    path = os.path.join(art_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        print(f"[skip] {path} exists")
        with open(path) as f:
            return json.load(f)
    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        dims, axes = PRODUCTION_SHAPES[mesh_kind]
        mesh = make_debug_mesh(dims, axes, device="cpu")
    sizes = mesh_sizes(mesh)
    chips = mesh.size()
    t0 = time.time()
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": chips,
        "mesh_shape": sizes, "device": DEVICE, "status": "ok",
    }
    try:
        cell = build_cell(cfg, shape)
        rec["param_count"] = param_count(cell.api.param_specs)
        rec["param_bytes"] = param_bytes(cell.api.param_specs)
        low = lower_cell(cell, mesh)
        cost = {"flops": low.flops, "bytes accessed": low.bytes_accessed}
        mem = {"argument_size_in_bytes": low.argument_bytes,
               "temp_size_in_bytes": max(low.peak_bytes - low.argument_bytes, 0)}
        ac = analytic_costs(cfg, shape)
        terms = roofline_terms(cost, low.collectives, chips, analytic=ac, sizes=sizes)
        per_dev = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        rec.update(
            param_bytes_per_device=low.argument_bytes_by_arg[0],
            lower_s=round(low.seconds, 2),
            cost=cost,
            memory=mem,
            collectives=collective_bytes(low.collectives),
            collective_counts={k: v["count"] for k, v in low.collectives.items()},
            roofline=terms,
            bytes_per_device=per_dev,
            fits_hbm=bool(per_dev <= HBM_BYTES),
            fits_hbm_basis=FITS_BASIS,
        )
        print(
            f"[ok] {arch} {shape_name} {mesh_kind}: lower={low.seconds:.1f}s "
            f"flops/chip={terms['flops_per_chip']:.3g} "
            f"coll={terms['collective_bytes_per_chip']:.3g}B "
            f"dom={terms['dominant']} frac={terms['roofline_fraction']:.3f} "
            f"mem/dev={per_dev / 2**30:.2f}GiB", flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} {shape_name} {mesh_kind}: {rec['error'][:300]}", flush=True)
    rec["seconds"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    todo = {"single": [], "multi": []}
    for arch, shape_name, skipped in cells(include_skipped=True):
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape_name != args.shape:
            continue
        if skipped:
            # record the documented skip (long_500k on quadratic-attention archs)
            os.makedirs(ART_DIR, exist_ok=True)
            for mesh_kind in ("single", "multi"):
                path = os.path.join(ART_DIR, f"{arch}__{shape_name}__{mesh_kind}.json")
                if not os.path.exists(path):
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                                   "status": "skipped",
                                   "reason": "long_500k needs sub-quadratic attention"},
                                  f, indent=1)
            continue
        for mesh_kind in ("single", "multi"):
            if args.mesh and mesh_kind != args.mesh:
                continue
            todo[mesh_kind].append((arch, shape_name))

    import torch.distributed as dist

    print(f"dry-run: {sum(map(len, todo.values()))} cells")
    n_ok = n_fail = 0
    for mesh_kind, todo_cells in todo.items():
        if not todo_cells:
            continue
        dims, axes = PRODUCTION_SHAPES[mesh_kind]
        fake_group(math.prod(dims))
        try:
            mesh = make_debug_mesh(dims, axes, device="cpu")
            for arch, shape_name in todo_cells:
                rec = run_cell(arch, shape_name, mesh_kind, force=args.force, mesh=mesh)
                n_ok += rec.get("status") == "ok"
                n_fail += rec.get("status") == "error"
        finally:
            dist.destroy_process_group()
    print(f"done: {n_ok} ok, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
