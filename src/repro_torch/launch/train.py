"""Training entry point — counterpart of ``repro.launch.train``: real steps on
one device, the card unless ``device="cpu"``.

Behaviors (held against the reference in ``tests/test_torch_train*.py``):
  * a train step of ``torch.autograd`` gradients through ``loss_fn`` (each
    unit under the config's remat) and an optimizer update written in place
  * deterministic data replay keyed only by the step counter
  * periodic async checkpointing in the reference's format; ``--resume``
    restores params, optimizer state and step from the latest checkpoint,
    whichever package wrote it, and continues
  * optional int8 gradient compression with error feedback (--compress-grads)

Under a mesh (``mesh=``, a ``DeviceMesh`` over an initialized default group,
every rank calling ``train`` alike) the parameters, the AdamW state and the
error-feedback buffers are DTensors placed per ``sharding_tree``, each batch
is sharded on the batch axes, and the step runs under
``axis_rules(mesh, rules_for(cfg, shape))``: the MoE layers take their
expert-parallel islands.  Losses come back as floats; checkpoints are
gathered to full tensors and written by the mesh's first rank, in the
reference's format.

Usage (the smoke configs run on the CPU; without ``--device cpu`` on the card,
without ``--smoke`` at the published widths, ``--layers`` cutting the depth):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --smoke \\
      --steps 20 --device cpu --ckpt-dir /tmp/ck --ckpt-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --steps 4 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --layers 4 --steps 4 --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \\
      --steps 4 --batch 2 --seq 4096

The encoder-decoder's and the VLM's batches carry their stub frames or
patches (``TokenPipeline.with_frontend``): seamless-m4t-medium encodes
seq / 4 frames, internvl2-2b puts 256 patches ahead of the seq text tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import ARCHS, SHAPES, ShapeConfig, smoke_shape
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..models import build_model
from ..optim import OptConfig, compress_tree, init_ef, opt_init, opt_state_specs, opt_update
from ..runtime.sharding import axis_rules, distribute_tree, full_tree, materialize
from .steps import opt_config_for, rules_for, value_and_grad

__all__ = ["main", "make_train_state", "train"]


def make_train_state(api, ocfg: OptConfig, seed: int = 0, device=None, mesh=None,
                     rules=None) -> Dict[str, Any]:
    """Parameters drawn from ``seed`` (``materialize``) and a fresh optimizer
    state, on ``device`` (default: the card); on ``mesh`` the parameters
    are DTensors placed per ``sharding_tree`` under ``rules``, and the
    state takes their placements."""
    device = resolve_device(device)
    params = materialize(api.param_specs, seed, device)
    if mesh is not None:
        params = distribute_tree(params, api.param_specs, mesh, rules)
    return {"params": params, "opt": opt_init(ocfg, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _scalar(x) -> float:
    return float(full_tree(x)) if torch.is_tensor(x) else float(x)


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 20,
    shape: Optional[ShapeConfig] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    compress_grads: bool = False,
    log_every: int = 10,
    seed: int = 0,
    data_source: str = "markov",
    lr: float = 3e-4,
    layers: Optional[int] = None,
    device=None,
    mesh=None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Train ``arch`` (its ``.smoke()`` reduction unless ``smoke=False``; its
    depth cut to ``layers`` if given, other config fields replaced by
    ``overrides``) up to step ``steps`` on ``device``
    (default: the card).

    Returns ``losses`` (one float a step run here), ``state`` (``params``,
    ``opt``, ``step``: tensors on ``device``), ``config``, and ``history``:
    a dict a step of its ``loss``, ``lr``, ``gnorm`` and host wall ``ms``
    (the loss is read back every step, so a step's wall covers its device
    work).  On ``mesh`` the state's tensors are DTensors (``full_tree``
    gathers them)."""
    device = resolve_device(device)
    if mesh is not None and torch.device(mesh.device_type).type != device.type:
        raise ValueError(f"mesh on {mesh.device_type}, device {device}")
    cfg = ARCHS[arch].smoke() if smoke else ARCHS[arch]
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or (smoke_shape("train") if smoke else SHAPES["train_4k"])
    api = build_model(cfg)
    ocfg = opt_config_for(cfg, total_steps=max(steps, 10))
    ocfg = dataclasses.replace(ocfg, lr=lr, warmup_steps=min(20, max(steps // 10, 1)))
    pipe = TokenPipeline(DataConfig(seed=seed + 1, source=data_source), cfg, shape)
    rules = rules_for(cfg, shape) if mesh is not None else None
    writer = mesh is None or mesh.get_rank() == mesh.mesh.flatten()[0].item()

    def step_fn(state, batch, ef):
        (loss, _), grads = value_and_grad(api.loss_fn, state["params"], batch)
        if compress_grads:
            grads, ef = compress_tree(grads, ef)
        _, _, om = opt_update(ocfg, grads, state["opt"], state["params"])
        state["step"] += 1
        return dict(loss=loss, **om), ef

    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    place = (lambda tree, specs: tree) if mesh is None else (
        lambda tree, specs: distribute_tree(tree, specs, mesh, rules))
    state = None
    start_step = 0
    if resume and ck and ck.latest_step() is not None:
        restored = ck.restore(device=device)
        start_step = int(restored["meta"]["step"])
        state = {
            "params": place(restored["params"], api.param_specs),
            "opt": place(restored["opt"], opt_state_specs(ocfg, api.param_specs)),
            "step": torch.tensor(start_step, dtype=torch.int32, device=device),
        }
        print(f"[train] resumed from step {start_step}")
    if state is None:
        state = make_train_state(api, ocfg, seed, device, mesh, rules)

    ef = init_ef(state["params"]) if compress_grads else None

    losses: List[float] = []
    history: List[Dict[str, float]] = []
    t0 = time.time()
    for s in range(start_step, steps):
        t_step = time.perf_counter()
        raw = pipe.with_frontend(pipe.batch_at(s), s)
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        batch = place(batch, api.batch_specs(shape))
        with axis_rules(mesh, rules):
            metrics, ef = step_fn(state, batch, ef)
        losses.append(_scalar(metrics["loss"]))
        history.append({"loss": losses[-1], "lr": _scalar(metrics["lr"]),
                        "gnorm": _scalar(metrics["gnorm"]),
                        "ms": 1e3 * (time.perf_counter() - t_step)})
        if log_every and (s + 1) % log_every == 0:
            dt = (time.time() - t0) / max(s + 1 - start_step, 1)
            print(
                f"[train] step {s+1} loss={losses[-1]:.4f} "
                f"lr={history[-1]['lr']:.2e} gnorm={history[-1]['gnorm']:.2f} "
                f"({dt*1e3:.0f} ms/step)"
            )
        if ck and ckpt_every and (s + 1) % ckpt_every == 0:
            # every rank gathers (a collective); the first one writes
            tree = full_tree({"params": state["params"], "opt": state["opt"]})
            if writer:
                ck.save(s + 1, {**tree, "meta": {"step": np.asarray(s + 1)}}, blocking=False)
    if ck:
        ck.wait()
    return {"losses": losses, "state": state, "config": cfg, "history": history}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay as published)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's: 2 smoke, 256 train_4k)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's: 64 smoke, 4096 train_4k)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    shape = None
    if args.batch is not None or args.seq is not None:
        base = smoke_shape("train") if args.smoke else SHAPES["train_4k"]
        shape = ShapeConfig(base.name, args.seq or base.seq_len, args.batch or base.global_batch,
                            "train")
    out = train(
        args.arch,
        smoke=args.smoke,
        steps=args.steps,
        shape=shape,
        layers=args.layers,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        compress_grads=args.compress_grads,
        device=args.device,
    )
    if out["losses"]:
        print(f"final loss: {out['losses'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
