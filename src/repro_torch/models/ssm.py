"""Mamba2 (SSD) language model and the Zamba2 hybrid (Mamba2 + one shared
attention block applied every k layers) — counterpart of
``repro.models.ssm``.

Parameter and cache trees are the reference's, leaf for leaf.  Where the
reference scans the stacked layers (units) with ``lax.scan``, a Python loop
walks them, each under the config's rematerialization (``_maybe_remat``)
when gradients are taken; zamba2's unscanned tail layers run without it, as
in the reference.  A cached call returns a new cache: each SSD layer's
``conv`` and ``state`` are new tensors (stacked as the scan stacks them),
while the shared block's k and v are written into the cache's tensors in
place, as the decoder's are.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..runtime.sharding import ParamSpec, replicate_like, shard
from .layers import (
    _mm,
    apply_mlp,
    apply_norm,
    apply_ssd,
    attention_block,
    attention_specs,
    embed_lookup,
    mlp_specs,
    norm_specs,
    softcap,
    ssd_specs,
)
from .transformer import _remat_if_grad, _tree_units, stack_specs

__all__ = ["mamba_cache_specs", "mamba_forward", "mamba_specs", "zamba_cache_specs",
           "zamba_forward", "zamba_specs", "zamba_units"]


def _embed(params: Dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return shard(embed_lookup(params["embed"], tokens).to(cfg.adtype), "batch", "seq", None)


def _ssd_layer(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
               lcache: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm SSD layer with its residual: (x + h, the layer's new cache)."""
    h, nc = apply_ssd(lp["ssd"], apply_norm(lp["ln"], x, cfg), cfg, cache=lcache)
    return x + h, nc


# ---------------------------------------------------------------------------
# Mamba2 LM
# ---------------------------------------------------------------------------


def mamba_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    unit = {"ln": norm_specs(cfg, d), "ssd": ssd_specs(cfg)}
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "fsdp"), init="embed", scale=0.02),
        "blocks": stack_specs(unit, cfg.num_layers),
        "ln_f": norm_specs(cfg, d),
    }


def mamba_cache_specs(cfg: ModelConfig, batch: int) -> Dict:
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    conv_dim = di + 2 * N
    U = cfg.num_layers
    return {
        "conv": ParamSpec((U, batch, cfg.ssm_conv - 1, conv_dim), (None, "batch", None, "ffn")),
        "state": ParamSpec(
            (U, batch, H, N, cfg.ssm_head_dim),
            (None, "batch", "ssm_heads", "state", None),
            torch.float32,
        ),
    }


def _mamba_unit(x: torch.Tensor, up: Dict, cfg: ModelConfig) -> torch.Tensor:
    return _ssd_layer(up, x, cfg)[0]


def mamba_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (float32 logits through ``softcap``, new cache or None, a
    zero aux loss).  ``cache`` is a tree from ``mamba_cache_specs`` (no
    ``"len"``: the SSM carries its history in ``conv`` and ``state``)."""
    x = _embed(params, tokens, cfg)
    units = _tree_units(params["blocks"], cfg.num_layers)
    new_cache = None
    if cache is None:
        unit = _remat_if_grad(_mamba_unit, cfg)
        for up in units:
            x = unit(x, up, cfg)
    else:
        convs, states = [], []
        for u, up in enumerate(units):
            x, nc = _ssd_layer(up, x, cfg, {"conv": cache["conv"][u], "state": cache["state"][u]})
            convs.append(nc["conv"])
            states.append(nc["state"])
        new_cache = {"conv": torch.stack(convs), "state": torch.stack(states)}
    x = apply_norm(params["ln_f"], x, cfg)
    logits = _mm(x, params["embed"].T.to(cfg.adtype))
    logits = softcap(logits.float(), cfg.logit_softcap)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(logits, "batch", "seq", "vocab"), new_cache, aux


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------


def _shared_block_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "ln_in": norm_specs(cfg, 2 * d),
        "proj_in": ParamSpec((2 * d, d), ("fsdp", None)),
        "ln_attn": norm_specs(cfg, d),
        "attn": attention_specs(cfg),
        "ln_mlp": norm_specs(cfg, d),
        "mlp": mlp_specs(cfg, d, cfg.d_ff),
    }


def zamba_units(cfg: ModelConfig) -> Tuple[int, int]:
    U = cfg.num_layers // cfg.shared_attn_every
    tail = cfg.num_layers % cfg.shared_attn_every
    return U, tail


def zamba_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    U, tail = zamba_units(cfg)
    munit = {
        f"m{i}": {"ln": norm_specs(cfg, d), "ssd": ssd_specs(cfg)}
        for i in range(cfg.shared_attn_every)
    }
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "fsdp"), init="embed", scale=0.02),
        "blocks": stack_specs(munit, U),
        "shared": _shared_block_specs(cfg),  # ONE set of attention params, applied U times
        "ln_f": norm_specs(cfg, d),
    }
    if tail:
        specs["tail"] = {
            f"t{i}": {"ln": norm_specs(cfg, d), "ssd": ssd_specs(cfg)}
            for i in range(tail)
        }
    return specs


def zamba_cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    conv_dim = di + 2 * N
    U, tail = zamba_units(cfg)
    KV, hd = cfg.num_kv_heads, cfg.hd
    E = cfg.shared_attn_every
    c: Dict[str, Any] = {
        "conv": ParamSpec((U, E, batch, cfg.ssm_conv - 1, conv_dim),
                          (None, None, "batch", None, "ffn")),
        "state": ParamSpec(
            (U, E, batch, H, N, cfg.ssm_head_dim),
            (None, None, "batch", "ssm_heads", "state", None), torch.float32,
        ),
        # a KV cache for each application of the shared attention block
        "shared_k": ParamSpec((U, batch, cache_len, KV, hd),
                              (None, "batch", "cache_seq", "kv_heads", None)),
        "shared_v": ParamSpec((U, batch, cache_len, KV, hd),
                              (None, "batch", "cache_seq", "kv_heads", None)),
    }
    if tail:
        c["tail_conv"] = ParamSpec((tail, batch, cfg.ssm_conv - 1, conv_dim),
                                   (None, "batch", None, "ffn"))
        c["tail_state"] = ParamSpec(
            (tail, batch, H, N, cfg.ssm_head_dim),
            (None, "batch", "ssm_heads", "state", None), torch.float32,
        )
    return c


def _shared_apply(shared: Dict, x: torch.Tensor, x0: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, kcache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The shared attention and MLP block on concat(x, x0) (Zamba's wiring)."""
    h = torch.cat([x, x0], dim=-1)
    h = _mm(apply_norm(shared["ln_in"], h, cfg), shared["proj_in"])
    a, nc = attention_block(
        shared["attn"], apply_norm(shared["ln_attn"], h, cfg), positions, cfg,
        layer_type="global", cache=kcache,
    )
    h = h + a
    h = h + apply_mlp(shared["mlp"], apply_norm(shared["ln_mlp"], h, cfg), cfg)
    return x + h, nc


def _zamba_unit(x: torch.Tensor, x0: torch.Tensor, up: Dict, shared: Dict,
                positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One unit without a cache: ``shared_attn_every`` SSD layers, then the
    shared block (the reference's scan body)."""
    for i in range(cfg.shared_attn_every):
        x = _ssd_layer(up[f"m{i}"], x, cfg)[0]
    return _shared_apply(shared, x, x0, positions, cfg, None)[0]


def zamba_forward(
    params: Dict,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
    cache_len=None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits in the activation dtype, new cache or None, a zero
    aux loss).  ``cache`` is a tree from ``zamba_cache_specs`` plus
    ``"len"`` (an int); ``cache_len`` (an int or a 0-dim tensor) is the
    first token's position.  The shared block's gradient sums its U
    applications; the embedding's arrives through ``x0`` and the tied
    head."""
    B, S = tokens.shape
    U, tail = zamba_units(cfg)
    E = cfg.shared_attn_every
    x0 = _embed(params, tokens, cfg)
    start = 0 if cache_len is None else int(cache_len)
    positions = torch.arange(start, start + S, dtype=torch.int32, device=x0.device)
    positions = shard(replicate_like(positions[None].expand(B, S), x0), "batch", "residual_seq")
    shared = params["shared"]
    units = _tree_units(params["blocks"], U)

    x = x0
    new_cache = None
    if cache is None:
        unit = _remat_if_grad(_zamba_unit, cfg)
        for up in units:
            x = unit(x, x0, up, shared, positions, cfg)
    else:
        clen = int(cache["len"])
        convs, states = [], []
        for u, up in enumerate(units):
            for i in range(E):
                x, nc = _ssd_layer(up[f"m{i}"], x, cfg,
                                   {"conv": cache["conv"][u, i], "state": cache["state"][u, i]})
                convs.append(nc["conv"])
                states.append(nc["state"])
            kcache = {"k": cache["shared_k"][u], "v": cache["shared_v"][u], "len": clen}
            x, _ = _shared_apply(shared, x, x0, positions, cfg, kcache)
        new_cache = {
            "conv": torch.stack(convs).unflatten(0, (U, E)),
            "state": torch.stack(states).unflatten(0, (U, E)),
            "shared_k": cache["shared_k"],
            "shared_v": cache["shared_v"],
            "len": clen + S,
        }
    # the tail SSD layers (unscanned, no remat)
    if tail:
        tconvs, tstates = [], []
        for i in range(tail):
            lc = None
            if cache is not None:
                lc = {"conv": cache["tail_conv"][i], "state": cache["tail_state"][i]}
            x, nc = _ssd_layer(params["tail"][f"t{i}"], x, cfg, lc)
            if cache is not None:
                tconvs.append(nc["conv"])
                tstates.append(nc["state"])
        if cache is not None:
            new_cache["tail_conv"] = torch.stack(tconvs)
            new_cache["tail_state"] = torch.stack(tstates)
    x = apply_norm(params["ln_f"], x, cfg)
    logits = _mm(x, params["embed"].T.to(cfg.adtype))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(logits, "batch", "seq", "vocab"), new_cache, aux
