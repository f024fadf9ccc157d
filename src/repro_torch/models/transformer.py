"""Decoder-only transformer, the dense and MoE families — counterpart of the
decoder of ``repro.models.transformer``.

Layers are grouped into the config's repeating ``layer_pattern`` unit and
their params stacked along a leading units dim (U = ``num_units(cfg)``), as
in the reference, so that a parameter tree converts leaf for leaf: e.g.
``blocks/l0/attn/wq`` is (U, d, H * hd).  Where the reference scans the
units with ``lax.scan``, a Python loop walks them, each unit under the
config's rematerialization (``_maybe_remat``) when gradients are taken, and
the MoE layers' aux losses are summed in the scan's order.  The
``first_k_dense`` prefix (dense ``"global"`` layers before the units) runs
unstacked, with a cache of its own.  Patches, the encoder-decoder and
``build_xattn_cache`` wait (ROADMAP Queue 1 item 7.4).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..runtime.sharding import ParamSpec, shard
from .layers import (
    apply_mlp,
    apply_moe,
    apply_norm,
    attention_block,
    attention_specs,
    mlp_specs,
    moe_specs,
    norm_specs,
    softcap,
)

__all__ = ["DecoderLM", "cache_specs", "decoder_forward", "decoder_specs", "num_units",
           "stack_specs"]

# the ROADMAP item each family that is not ported yet waits for
_WAITS = {
    "encdec": "ROADMAP Queue 1 item 7.4 (encdec and vlm)",
    "vlm": "ROADMAP Queue 1 item 7.4 (encdec and vlm)",
}


def _require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item ``cfg``'s family
    waits for, unless it is a ported one (dense, MoE, and the SSM and hybrid
    families of ``models.ssm``)."""
    if cfg.family in ("dense", "moe", "ssm", "hybrid") and cfg.frontend is None:
        return
    item = _WAITS.get(cfg.family, "ROADMAP Queue 1 item 7")
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet; it waits for {item}")


# ---------------------------------------------------------------------------
# spec helpers
# ---------------------------------------------------------------------------


def stack_specs(tree, n: int):
    """Prepend a stacked-units dim to every ParamSpec leaf."""
    if isinstance(tree, dict):
        return {k: stack_specs(v, n) for k, v in tree.items()}
    ps: ParamSpec = tree
    return ParamSpec((n,) + ps.shape, (None,) + ps.logical, ps.dtype, ps.init, ps.scale)


def _tree_units(tree, n: int) -> List[Dict]:
    """The stacked tree as ``n`` per-unit trees of views, one ``unbind`` a
    leaf: gradients reach the stacked leaf through the views, and unbind's
    backward stacks the units' gradients in one copy (a view per unit would
    add a zero-filled full-size gradient per unit)."""
    if isinstance(tree, dict):
        subs = {k: _tree_units(v, n) for k, v in tree.items()}
        return [{k: subs[k][u] for k in subs} for u in range(n)]
    return list(tree.unbind(0))


def num_units(cfg: ModelConfig) -> int:
    pat = len(cfg.layer_pattern)
    layers = cfg.num_layers - cfg.first_k_dense
    if layers % pat:
        raise ValueError(f"{cfg.name}: {layers} layers do not tile the pattern of {pat}")
    return layers // pat


def _sub_block_specs(cfg: ModelConfig, moe: bool) -> Dict:
    d = cfg.d_model
    p = {
        "ln_attn": norm_specs(cfg, d),
        "attn": attention_specs(cfg),
        "ln_mlp": norm_specs(cfg, d),
    }
    if moe:
        p["moe"] = moe_specs(cfg)
    else:
        p["mlp"] = mlp_specs(cfg, d, cfg.d_ff)
    return p


def decoder_specs(cfg: ModelConfig) -> Dict:
    _require_ported(cfg)
    d = cfg.d_model
    moe = cfg.family == "moe"
    unit = {f"l{i}": _sub_block_specs(cfg, moe) for i in range(len(cfg.layer_pattern))}
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "fsdp"), init="embed", scale=0.02),
        "blocks": stack_specs(unit, num_units(cfg)),
        "ln_f": norm_specs(cfg, d),
    }
    if cfg.first_k_dense:
        specs["prefix"] = {f"p{i}": _sub_block_specs(cfg, moe=False)
                           for i in range(cfg.first_k_dense)}
    return specs


# ---------------------------------------------------------------------------
# cache declaration
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    KV, hd = cfg.num_kv_heads, cfg.hd
    U = num_units(cfg)
    kv = {
        "k": ParamSpec((U, batch, cache_len, KV, hd), (None, "batch", "cache_seq", "kv_heads", None)),
        "v": ParamSpec((U, batch, cache_len, KV, hd), (None, "batch", "cache_seq", "kv_heads", None)),
    }
    c: Dict[str, Any] = {f"l{i}": dict(kv) for i in range(len(cfg.layer_pattern))}
    if cfg.first_k_dense:
        pkv = {
            "k": ParamSpec((batch, cache_len, KV, hd), ("batch", "cache_seq", "kv_heads", None)),
            "v": ParamSpec((batch, cache_len, KV, hd), ("batch", "cache_seq", "kv_heads", None)),
        }
        c["prefix"] = {f"p{i}": dict(pkv) for i in range(cfg.first_k_dense)}
    return c


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _one_layer(
    lp: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    layer_type: str,
    lcache: Optional[Dict],
    aux: torch.Tensor,
):
    """pre-LN attention + (moe|mlp); returns (x, new_cache, aux plus the
    layer's aux loss; a dense layer adds nothing)."""
    h, new_cache = attention_block(
        lp["attn"], apply_norm(lp["ln_attn"], x, cfg), positions, cfg,
        layer_type=layer_type, cache=lcache,
    )
    x = x + h
    h2in = apply_norm(lp["ln_mlp"], x, cfg)
    if "moe" in lp:
        h2, a = apply_moe(lp["moe"], h2in, cfg)
        aux = aux + a
    else:
        h2 = apply_mlp(lp["mlp"], h2in, cfg)
    return x + h2, new_cache, aux


def _unit(x: torch.Tensor, aux: torch.Tensor, up: Dict, positions: torch.Tensor,
          cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeating unit (``cfg.layer_pattern``) without a cache: the
    reference's scan body, carrying (x, aux)."""
    for i, lt in enumerate(cfg.layer_pattern):
        x, _, aux = _one_layer(up[f"l{i}"], x, positions, cfg, lt, None, aux)
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of matmuls without batch dims
    (``x @ w`` reaches the dispatcher as ``aten.mm``; the attention's
    einsums, with batch dims, are ``bmm``), recompute everything else —
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat``: ``"none"`` saves every activation the
    backward needs, ``"full"`` saves only the unit's inputs and recomputes
    the unit in the backward, ``"dots"`` keeps the matmul outputs
    (:func:`_save_dots`) and recomputes the rest."""
    if cfg.remat == "none":
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw: Dict[str, Any] = {"use_reentrant": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat != "full":
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    return lambda *args: checkpoint(fn, *args, **kw)


def _remat_if_grad(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under the config's remat where a backward will run: under
    ``no_grad`` or ``inference_mode`` there is nothing to save."""
    return _maybe_remat(fn, cfg) if torch.is_grad_enabled() else fn


def decoder_forward(
    params: Dict,
    tokens: torch.Tensor,  # (B, S) int32
    cfg: ModelConfig,
    *,
    cache: Optional[Dict] = None,
    cache_len=None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss): aux_loss sums the MoE layers'
    load-balancing losses (0 for the dense family).

    With ``cache`` (a tree from ``cache_specs`` plus ``"len"``), the new
    tokens' k and v are written into its tensors in place and the returned
    cache holds the same tensors with ``len + S``.  ``cache_len`` (an int or
    a 0-dim tensor) is the first token's position.
    """
    _require_ported(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.adtype)
    start = 0 if cache_len is None else int(cache_len)
    x = shard(x, "batch", "residual_seq", None)
    positions = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
    positions = positions[None].expand(B, S)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    clen = None if cache is None else int(cache["len"])

    # the unstacked prefix (e.g. kimi's first dense layer), its cache apart
    for i in range(cfg.first_k_dense):
        lc = None if cache is None else {**cache["prefix"][f"p{i}"], "len": clen}
        x, _, aux = _one_layer(params["prefix"][f"p{i}"], x, positions, cfg, "global", lc, aux)

    units = _tree_units(params["blocks"], num_units(cfg))
    new_cache = None
    if cache is None:
        unit = _remat_if_grad(_unit, cfg)
        for up in units:
            x, aux = unit(x, aux, up, positions, cfg)
    else:
        new_cache = {f"l{i}": {"k": cache[f"l{i}"]["k"], "v": cache[f"l{i}"]["v"]}
                     for i in range(len(cfg.layer_pattern))}
        if cfg.first_k_dense:
            new_cache["prefix"] = {p: {"k": c["k"], "v": c["v"]}
                                   for p, c in cache["prefix"].items()}
        new_cache["len"] = clen + S
        for u, up in enumerate(units):
            for i, lt in enumerate(cfg.layer_pattern):
                lc = {"k": cache[f"l{i}"]["k"][u], "v": cache[f"l{i}"]["v"][u], "len": clen}
                x, _, aux = _one_layer(up[f"l{i}"], x, positions, cfg, lt, lc, aux)

    x = apply_norm(params["ln_f"], x, cfg)
    x = shard(x, "batch", "residual_seq", None)
    logits = x @ params["embed"].T.to(cfg.adtype)  # tied head
    logits = softcap(logits.float(), cfg.logit_softcap)
    return shard(logits, "batch", "residual_seq", "vocab"), new_cache, aux


class _Tree(nn.Module):
    """One dict of the parameter tree: leaves as parameters (with gradients
    only when ``requires_grad``), dicts as child modules, under the
    reference's keys."""

    def __init__(self, tree: Dict, requires_grad: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v, requires_grad))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=requires_grad))

    def tree(self) -> Dict:
        out: Dict[str, Any] = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class DecoderLM(_Tree):
    """The decoder as an ``nn.Module``: ``params`` (a tree from
    ``materialize(decoder_specs(cfg), ...)`` or ``params_from_numpy``) held
    under the reference's paths, so that ``state_dict()`` keys are those
    paths joined by dots (``blocks.l0.attn.wq``).  ``forward`` is
    :func:`decoder_forward` on ``tree()``.  ``requires_grad=True`` makes the
    leaves trainable (``torch.optim`` over ``parameters()``, or the port's
    ``optim`` over ``tree()``); serving keeps the default, no gradients."""

    def __init__(self, cfg: ModelConfig, params: Dict, requires_grad: bool = False):
        super().__init__(params, requires_grad)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None):
        return decoder_forward(
            self.tree(), tokens, self.cfg, cache=cache,
            cache_len=None if cache is None else cache["len"],
        )
