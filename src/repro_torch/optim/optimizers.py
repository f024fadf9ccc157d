"""Optimizers — counterpart of ``repro.optim.optimizers``: AdamW (state in
float32, bfloat16 or per-row int8), Adafactor (factored second moments) and
the warmup-cosine schedule, over nested dicts of tensors.

State memory per parameter (bytes):
    adamw fp32:   8      adamw bf16: 4      adamw int8: 2 (+ per-row scales)
    adafactor:    ~0     (row+col factors for 2D+, full v for 1D)

The state tree has the reference's shape, ``{"mu": <one dict per leaf>,
"step": 0-dim int32}``, so that a checkpoint of either package restores in
the other.  ``*_update`` writes the new parameters and state into the
tensors it was given (under ``torch.no_grad()``) and returns them: the
reference donates both to its jitted step, and a step that kept the old
ones would hold two copies of every parameter and moment.

The float32 arithmetic is the reference's, op for op and in its order (a
Python scalar meets a float32 tensor as float32, as JAX's weak types do),
so that the int8 codes match; ``torch.round`` rounds half to even like
``jnp.round``.  Division by a value held as a Python float goes through a
0-dim tensor: on CUDA PyTorch turns ``x / c`` into ``x * (1 / c)``, and
``c / x`` into ``x.reciprocal() * c`` everywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

import torch

from ..runtime.sharding import ParamSpec

__all__ = [
    "OptConfig", "adafactor_init", "adafactor_update", "adamw_init", "adamw_update",
    "clip_by_global_norm", "clip_scale", "global_norm", "opt_init", "opt_state_specs",
    "opt_update", "schedule",
]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"  # float32 | bfloat16 | int8


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true quotient on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as a true quotient (PyTorch computes ``c / x`` as
    ``x.reciprocal() * c``)."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def _leaves(tree) -> List[torch.Tensor]:
    """The leaves in the reference's order (``jax.tree.leaves``: sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _zip_map(fn: Callable, params, *trees):
    """``fn(p, *others)`` for each leaf of ``params`` with the subtree at the
    same path in each of ``trees`` (``flatten_up_to``: a parameter's state is
    a dict of tensors)."""
    if isinstance(params, dict):
        return {k: _zip_map(fn, params[k], *(t[k] for t in trees)) for k in params}
    return fn(params, *trees)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, float32 like the step it is given."""
    step = step.float()
    warm = torch.clamp(_div(step, max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp(_div(step - cfg.warmup_steps, max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in _leaves(tree):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def clip_scale(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-norm clip factor without a float32 copy of every gradient."""
    n = global_norm(grads)
    return torch.clamp(_rdiv(max_norm, n + 1e-9), max=1.0), n


def clip_by_global_norm(grads, max_norm: float):
    scale, n = clip_scale(grads, max_norm)
    return _zip_map(lambda g: g.float() * scale, grads), n


# -- int8 state codec ---------------------------------------------------------


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (dim 0) symmetric int8 quantization of a float32 tensor."""
    red = tuple(range(1, x.ndim))
    # a vector or a scalar has rows of one element: its scale is per element
    amax = x.abs().amax(dim=red, keepdim=True) if red else x.abs()
    scale = torch.where(amax > 0, _div(amax, 127.0), 1.0)
    return torch.round(x / scale).to(torch.int8), scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# -- AdamW ---------------------------------------------------------------------


def adamw_init(cfg: OptConfig, params):
    def one(p):
        # distinct buffers for m and v: each is written in place (zeros_like
        # keeps a DTensor parameter's placements: no full-size buffer)
        def z(dt):
            return torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)

        if cfg.state_dtype == "bfloat16":
            return {"m": z(torch.bfloat16), "v": z(torch.bfloat16)}
        if cfg.state_dtype == "int8":
            qm, sm = _q8(z(torch.float32))
            qv, sv = _q8(z(torch.float32))
            return {"m": qm, "ms": sm, "v": qv, "vs": sv}
        return {"m": z(torch.float32), "v": z(torch.float32)}

    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    return {"mu": _zip_map(one, params), "step": step}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    cscale, gnorm = clip_scale(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def one(p, g, s):
        if cfg.state_dtype == "int8":
            m, v = _dq8(s["m"], s["ms"]), _dq8(s["v"], s["vs"])
        else:
            m, v = s["m"].float(), s["v"].float()  # the state itself when float32
        g = g.float() * cscale  # fused per-tensor clip
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        upd.add_(p.float() * cfg.weight_decay)
        p.copy_(p.float() - upd.mul_(lr))
        if cfg.state_dtype == "int8":
            for key, x in (("m", m), ("v", v)):
                q, sc = _q8(x)
                s[key].copy_(q)
                s[key + "s"].copy_(sc)
        elif cfg.state_dtype == "bfloat16":
            s["m"].copy_(m)
            s["v"].copy_(v)

    _zip_map(one, params, grads, state["mu"])
    return params, state, {"lr": lr, "gnorm": gnorm}


# -- Adafactor -------------------------------------------------------------------


def adafactor_init(cfg: OptConfig, params):
    def one(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
        if p.ndim >= 2:
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    return {"mu": _zip_map(one, params), "step": step}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    state["step"] += 1
    step = state["step"]
    lr = schedule(cfg, step)
    cscale, gnorm = clip_scale(grads, cfg.grad_clip)
    decay = 1.0 - step.float() ** -0.8

    def one(p, g, s):
        g = g.float() * cscale  # fused per-tensor clip
        g2 = g.square() + 1e-30
        if p.ndim >= 2:
            vr = decay * s["vr"] + (1 - decay) * g2.mean(-1)
            vc = decay * s["vc"] + (1 - decay) * g2.mean(-2)
            denom = vr.mean(-1, keepdim=True)
            prec = vr[..., None] * vc[..., None, :] / torch.clamp(denom[..., None], min=1e-30)
            upd = g / torch.sqrt(prec + 1e-30)
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
        else:
            v = decay * s["v"] + (1 - decay) * g2
            upd = g / torch.sqrt(v + 1e-30)
            s["v"].copy_(v)
        # update clipping by RMS (Adafactor d=1.0)
        rms = torch.sqrt(upd.square().mean() + 1e-30)
        upd = upd / torch.clamp(rms, min=1.0)
        upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)

    _zip_map(one, params, grads, state["mu"])
    return params, state, {"lr": lr, "gnorm": gnorm}


# -- state declaration (ParamSpec mirror of opt_init) ------------------------------


def opt_state_specs(cfg: OptConfig, param_specs):
    """ParamSpec tree for the optimizer state (no allocation)."""
    sdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        cfg.state_dtype, torch.float32
    )

    def one(ps: ParamSpec):
        if cfg.name == "adafactor":
            if len(ps.shape) >= 2:
                return {
                    "vr": ParamSpec(ps.shape[:-1], ps.logical[:-1], torch.float32, "zeros"),
                    "vc": ParamSpec(
                        ps.shape[:-2] + ps.shape[-1:],
                        ps.logical[:-2] + ps.logical[-1:],
                        torch.float32, "zeros",
                    ),
                }
            return {"v": ParamSpec(ps.shape, ps.logical, torch.float32, "zeros")}
        return {
            "m": ParamSpec(ps.shape, ps.logical, sdt, "zeros"),
            "v": ParamSpec(ps.shape, ps.logical, sdt, "zeros"),
        }

    return {"mu": _zip_map(one, param_specs), "step": ParamSpec((), (), torch.int32, "zeros")}


# -- facade ------------------------------------------------------------------------


def opt_init(cfg: OptConfig, params):
    return adafactor_init(cfg, params) if cfg.name == "adafactor" else adamw_init(cfg, params)


def opt_update(cfg: OptConfig, grads, state, params):
    """One step: the new parameters and state written into ``params`` and
    ``state``; returns ``(params, state, {"lr", "gnorm"})``."""
    if cfg.name == "adafactor":
        return adafactor_update(cfg, grads, state, params)
    return adamw_update(cfg, grads, state, params)
