"""Decoder-only transformer (dense, MoE, the VLM's patch prefix) and the
encoder-decoder — counterpart of ``repro.models.transformer``.

Layers are grouped into the config's repeating ``layer_pattern`` unit and
their params stacked along a leading units dim (U = ``num_units(cfg)``), as
in the reference, so that a parameter tree converts leaf for leaf: e.g.
``blocks/l0/attn/wq`` is (U, d, H * hd).  Where the reference scans the
units with ``lax.scan``, a Python loop walks them, each unit under the
config's rematerialization (``_maybe_remat``) when gradients are taken, and
the MoE layers' aux losses are summed in the scan's order.  The
``first_k_dense`` prefix (dense ``"global"`` layers before the units) runs
unstacked, with a cache of its own.  A VLM's patches, projected by
``frontend_proj``, go ahead of the text tokens.  The encoder-decoder's
bidirectional encoder (``encoder_forward``) feeds every decoder layer's
cross-attention, its K and V computed from the encoder output or read from
the cache's ``xkv`` entry (``build_xattn_cache``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..runtime.sharding import ParamSpec, replicate_like, shard
from .layers import (
    _einsum,
    _mm,
    apply_mlp,
    apply_moe,
    apply_norm,
    attention_block,
    attention_specs,
    embed_lookup,
    mlp_specs,
    moe_specs,
    norm_specs,
    softcap,
)

__all__ = ["DecoderLM", "build_xattn_cache", "cache_specs", "decoder_forward",
           "decoder_specs", "encoder_forward", "num_units", "stack_specs"]


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
    if cfg.frontend == "patch":
        specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, d), ("frontend", "fsdp"))
    if cfg.family == "encdec":
        enc_unit = {"l0": _sub_block_specs(cfg, moe=False)}
        specs["encoder"] = {
            "blocks": stack_specs(enc_unit, cfg.encoder_layers),
            "ln_f": norm_specs(cfg, d),
            "frontend_proj": ParamSpec((cfg.frontend_dim, d), ("frontend", "fsdp")),
        }
        for i in range(len(cfg.layer_pattern)):
            unit[f"l{i}"]["ln_xattn"] = norm_specs(cfg, d)
            unit[f"l{i}"]["xattn"] = attention_specs(cfg)
        specs["blocks"] = stack_specs(unit, num_units(cfg))
    return specs


# ---------------------------------------------------------------------------
# cache declaration
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int, src_len: int = 0) -> Dict:
    """The KV cache's declaration; an encoder-decoder's also holds the
    cross-attention K and V of ``src_len`` source positions (``xkv``)."""
    KV, hd = cfg.num_kv_heads, cfg.hd
    U = num_units(cfg)
    L = len(cfg.layer_pattern)

    def kv(n):
        return {name: ParamSpec((U, batch, n, KV, hd),
                                (None, "batch", "cache_seq", "kv_heads", None))
                for name in ("k", "v")}

    c: Dict[str, Any] = {f"l{i}": kv(cache_len) for i in range(L)}
    if cfg.first_k_dense:
        pkv = {
            "k": ParamSpec((batch, cache_len, KV, hd), ("batch", "cache_seq", "kv_heads", None)),
            "v": ParamSpec((batch, cache_len, KV, hd), ("batch", "cache_seq", "kv_heads", None)),
        }
        c["prefix"] = {f"p{i}": dict(pkv) for i in range(cfg.first_k_dense)}
    if cfg.family == "encdec":
        # cross-attention K/V computed once from the encoder output
        c["xkv"] = {f"l{i}": kv(src_len) for i in range(L)}
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
    xattn_kv=None,
):
    """pre-LN attention (+ cross-attention over ``xattn_kv``) + (moe|mlp);
    returns (x, new_cache, aux plus the layer's aux loss; a dense layer adds
    nothing)."""
    h, new_cache = attention_block(
        lp["attn"], apply_norm(lp["ln_attn"], x, cfg), positions, cfg,
        layer_type=layer_type, cache=lcache,
    )
    x = x + h
    if xattn_kv is not None:
        hx, _ = attention_block(
            lp["xattn"], apply_norm(lp["ln_xattn"], x, cfg), positions, cfg,
            layer_type="global", causal=False, xattn_kv=xattn_kv,
        )
        x = x + hx
    h2in = apply_norm(lp["ln_mlp"], x, cfg)
    if "moe" in lp:
        h2, a = apply_moe(lp["moe"], h2in, cfg)
        aux = aux + a
    else:
        h2 = apply_mlp(lp["mlp"], h2in, cfg)
    return x + h2, new_cache, aux


def _enc_xkv(lp: Dict, enc_out: torch.Tensor, src_positions: torch.Tensor, cfg: ModelConfig):
    """A layer's cross-attention (k, v, kpos) from the encoder output."""
    B = enc_out.shape[0]
    KV, hd = cfg.num_kv_heads, cfg.hd
    k = _mm(enc_out, lp["xattn"]["wk"]).reshape(B, -1, KV, hd)
    v = _mm(enc_out, lp["xattn"]["wv"]).reshape(B, -1, KV, hd)
    return k, v, src_positions


def _unit(x: torch.Tensor, aux: torch.Tensor, up: Dict, positions: torch.Tensor,
          cfg: ModelConfig, enc_out: Optional[torch.Tensor] = None,
          src_positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One repeating unit (``cfg.layer_pattern``) without a cache: the
    reference's scan body, carrying (x, aux); an encoder-decoder's layers
    attend to ``enc_out`` (its cross K/V recomputed with the unit under
    remat, as the reference's are)."""
    for i, lt in enumerate(cfg.layer_pattern):
        lp = up[f"l{i}"]
        xkv = None if enc_out is None else _enc_xkv(lp, enc_out, src_positions, cfg)
        x, _, aux = _one_layer(lp, x, positions, cfg, lt, None, aux, xkv)
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
    patches: Optional[torch.Tensor] = None,  # (B, P, frontend_dim) for VLM
    enc_out: Optional[torch.Tensor] = None,  # (B, Ssrc, d) for enc-dec
    src_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss): aux_loss sums the MoE layers'
    load-balancing losses (0 for the dense family).

    With ``cache`` (a tree from ``cache_specs`` plus ``"len"``), the new
    tokens' k and v are written into its tensors in place and the returned
    cache holds the same tensors with ``len + S``.  ``cache_len`` (an int or
    a 0-dim tensor) is the first token's position.

    ``patches`` (VLM) are projected by ``frontend_proj`` and go ahead of the
    text, so the logits cover P + S positions.  An encoder-decoder's
    cross-attention reads K/V computed from ``enc_out`` at ``src_positions``
    when it is given, else the cache's ``xkv`` at positions 0..Ssrc-1.
    """
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(cfg.adtype)
    start = 0 if cache_len is None else int(cache_len)
    if patches is not None:
        pe = _mm(patches.to(cfg.adtype), params["frontend_proj"]).to(cfg.adtype)
        x = torch.cat([pe, x], dim=1)
        S = x.shape[1]
    encdec = cfg.family == "encdec"
    if encdec and enc_out is None and cache is None:
        raise ValueError(f"{cfg.name}: the decoder needs enc_out or a cache with xkv")
    x = shard(x, "batch", "residual_seq", None)
    positions = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
    positions = shard(replicate_like(positions[None].expand(B, S), x), "batch", "residual_seq")

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
            x, aux = unit(x, aux, up, positions, cfg, enc_out, src_positions)
    else:
        new_cache = {f"l{i}": {"k": cache[f"l{i}"]["k"], "v": cache[f"l{i}"]["v"]}
                     for i in range(len(cfg.layer_pattern))}
        if cfg.first_k_dense:
            new_cache["prefix"] = {p: {"k": c["k"], "v": c["v"]}
                                   for p, c in cache["prefix"].items()}
        if encdec:
            new_cache["xkv"] = cache["xkv"]
            if enc_out is None:  # decode: the cached cross K/V
                Ssrc = cache["xkv"]["l0"]["k"].shape[2]
                kpos = torch.arange(Ssrc, dtype=torch.int32, device=x.device)[None].expand(B, Ssrc)
        new_cache["len"] = clen + S
        for u, up in enumerate(units):
            for i, lt in enumerate(cfg.layer_pattern):
                lp = up[f"l{i}"]
                lc = {"k": cache[f"l{i}"]["k"][u], "v": cache[f"l{i}"]["v"][u], "len": clen}
                xkv = None
                if encdec:
                    if enc_out is not None:
                        xkv = _enc_xkv(lp, enc_out, src_positions, cfg)
                    else:
                        xc = cache["xkv"][f"l{i}"]
                        xkv = (xc["k"][u], xc["v"][u], kpos)
                x, _, aux = _one_layer(lp, x, positions, cfg, lt, lc, aux, xkv)

    x = apply_norm(params["ln_f"], x, cfg)
    x = shard(x, "batch", "residual_seq", None)
    logits = _mm(x, params["embed"].T.to(cfg.adtype))  # tied head
    logits = softcap(logits.float(), cfg.logit_softcap)
    return shard(logits, "batch", "residual_seq", "vocab"), new_cache, aux


def _enc_unit(x: torch.Tensor, lp: Dict, positions: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """One encoder layer: bidirectional self-attention, then the MLP."""
    h, _ = attention_block(
        lp["attn"], apply_norm(lp["ln_attn"], x, cfg), positions, cfg,
        layer_type="global", causal=False,
    )
    x = x + h
    return x + apply_mlp(lp["mlp"], apply_norm(lp["ln_mlp"], x, cfg), cfg)


def encoder_forward(params: Dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings (B, Ssrc, fdim),
    each layer under the config's remat when gradients are taken."""
    enc = params["encoder"]
    x = _mm(frames.to(cfg.adtype), enc["frontend_proj"]).to(cfg.adtype)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    unit = _remat_if_grad(_enc_unit, cfg)
    for up in _tree_units(enc["blocks"], cfg.encoder_layers):
        x = unit(x, up["l0"], positions, cfg)
    return apply_norm(enc["ln_f"], x, cfg)


def build_xattn_cache(params: Dict, enc_out: torch.Tensor, cfg: ModelConfig) -> Dict:
    """Precompute every unit's cross-attention K/V for decode: ``{"l<i>":
    {"k", "v"}}``, each (U, B, Ssrc, KV, hd), the cache's ``xkv`` entry."""
    B = enc_out.shape[0]
    KV, hd = cfg.num_kv_heads, cfg.hd
    out = {}
    for i in range(len(cfg.layer_pattern)):
        xp = params["blocks"][f"l{i}"]["xattn"]
        out[f"l{i}"] = {
            name: _einsum("bsd,udk->ubsk", enc_out, xp[w]).reshape(xp[w].shape[0], B, -1, KV, hd)
            for name, w in (("k", "wk"), ("v", "wv"))
        }
    return out


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

    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None, *,
                patches: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                src_positions: Optional[torch.Tensor] = None):
        return decoder_forward(
            self.tree(), tokens, self.cfg, cache=cache,
            cache_len=None if cache is None else cache["len"],
            patches=patches, enc_out=enc_out, src_positions=src_positions,
        )

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """An encoder-decoder's :func:`encoder_forward` on ``frames``."""
        return encoder_forward(self.tree(), frames, self.cfg)
