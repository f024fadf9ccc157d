"""Cells and their step functions — counterpart of ``repro.launch.steps``.

A "cell" is (architecture, input shape); this module turns a cell into its
step function plus the ParamSpec trees of its arguments.  The train step
takes gradients of ``loss_fn`` with ``torch.autograd`` (:func:`value_and_grad`)
and writes the new parameters and optimizer state into the tensors it was
given, the port's counterpart of the reference's donated arguments.

The mesh half of the reference's module (``rules_for``, ``cell_structs``,
``lower_cell``) waits for the port's mesh and cost model (ROADMAP Queue 1
item 7.6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import ModelAPI, build_model
from ..optim import OptConfig, opt_state_specs, opt_update
from ..optim.optimizers import _div, _leaves, _zip_map

__all__ = ["Cell", "build_cell", "opt_config_for", "value_and_grad"]


def opt_config_for(cfg: ModelConfig, total_steps: int = 10_000) -> OptConfig:
    return OptConfig(
        name=cfg.optimizer,
        state_dtype=cfg.opt_state_dtype,
        total_steps=total_steps,
    )


def value_and_grad(loss_fn: Callable, params: Dict, batch: Dict) -> Tuple[Tuple, Dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``:
    ``((loss, metrics), grads)`` with ``grads`` a tree like ``params``, each
    leaf in its parameter's dtype.  The parameters are taken through
    detached aliases (no copy), so the caller's tensors keep their flags and
    no ``.grad`` is written; the loss and metrics come back detached."""
    leaves = _zip_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        flat = _leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    by_id = {id(p): g for p, g in zip(flat, grads)}
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return (loss.detach(), metrics), _zip_map(lambda p: by_id[id(p)].detach(), leaves)


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    api: ModelAPI
    step_fn: Any            # the step: train_step, prefill_step or serve_step
    arg_specs: Tuple        # ParamSpec trees, one per argument
    donate: Tuple[int, ...]  # the arguments the step writes in place


def build_cell(cfg: ModelConfig, shape: ShapeConfig) -> Cell:
    api = build_model(cfg)
    if shape.kind == "train":
        ocfg = opt_config_for(cfg)
        A = max(1, cfg.grad_accum)

        def train_step(params, opt_state, batch):
            if A == 1:
                (loss, _), grads = value_and_grad(api.loss_fn, params, batch)
            else:
                # A micro-batches summed in the parameters' dtype, as the
                # reference's scan does
                gsum = _zip_map(torch.zeros_like, params)
                lsum = torch.zeros((), dtype=torch.float32, device=_leaves(params)[0].device)
                for a in range(A):
                    mb = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])[a]
                          for k, v in batch.items()}
                    (l, _), g = value_and_grad(api.loss_fn, params, mb)
                    gsum = _zip_map(lambda acc, x: acc + x.to(acc.dtype), gsum, g)
                    lsum = lsum + l
                grads = _zip_map(lambda g: _div(g, A), gsum)
                loss = _div(lsum, A)
            new_params, new_state, om = opt_update(ocfg, grads, opt_state, params)
            return new_params, new_state, dict(loss=loss, **om)

        ostate = opt_state_specs(ocfg, api.param_specs)
        return Cell(
            cfg, shape, api, train_step,
            (api.param_specs, ostate, api.batch_specs(shape)),
            donate=(0, 1),
        )
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return api.prefill_fn(params, batch)

        return Cell(cfg, shape, api, prefill_step,
                    (api.param_specs, api.batch_specs(shape)), donate=())

    # decode: the cache is written in place
    def serve_step(params, cache, batch):
        return api.decode_fn(params, cache, batch)

    return Cell(
        cfg, shape, api, serve_step,
        (api.param_specs, api.cache_decl(shape), api.batch_specs(shape)),
        donate=(1,),
    )
