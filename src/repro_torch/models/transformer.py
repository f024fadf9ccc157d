"""Decoder-only transformer, the dense family — counterpart of the dense part
of ``repro.models.transformer``.

Layers are grouped into the config's repeating ``layer_pattern`` unit and
their params stacked along a leading units dim (U = ``num_units(cfg)``), as
in the reference, so that a parameter tree converts leaf for leaf: e.g.
``blocks/l0/attn/wq`` is (U, d, H * hd).  Where the reference scans the
units with ``lax.scan``, a Python loop walks them.  ``first_k_dense``,
patches, the encoder-decoder and ``build_xattn_cache`` wait (ROADMAP Queue 1
item 7).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..runtime.sharding import ParamSpec, shard
from .layers import (
    apply_mlp,
    apply_norm,
    attention_block,
    attention_specs,
    mlp_specs,
    norm_specs,
    softcap,
)

__all__ = ["DecoderLM", "cache_specs", "decoder_forward", "decoder_specs", "num_units",
           "stack_specs"]

# the ROADMAP item each family that is not ported yet waits for
_WAITS = {
    "moe": "ROADMAP Queue 1 item 7.2 (MoE)",
    "ssm": "ROADMAP Queue 1 item 7.3 (ssm.py: mamba2, zamba2)",
    "hybrid": "ROADMAP Queue 1 item 7.3 (ssm.py: mamba2, zamba2)",
    "encdec": "ROADMAP Queue 1 item 7.4 (encdec and vlm)",
    "vlm": "ROADMAP Queue 1 item 7.4 (encdec and vlm)",
}


def _require_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item ``cfg``'s family
    waits for, unless it is the (ported) dense family."""
    if cfg.family == "dense" and not cfg.first_k_dense and cfg.frontend is None:
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


def _tree_index(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def num_units(cfg: ModelConfig) -> int:
    pat = len(cfg.layer_pattern)
    layers = cfg.num_layers - cfg.first_k_dense
    if layers % pat:
        raise ValueError(f"{cfg.name}: {layers} layers do not tile the pattern of {pat}")
    return layers // pat


def _sub_block_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    return {
        "ln_attn": norm_specs(cfg, d),
        "attn": attention_specs(cfg),
        "ln_mlp": norm_specs(cfg, d),
        "mlp": mlp_specs(cfg, d, cfg.d_ff),
    }


def decoder_specs(cfg: ModelConfig) -> Dict:
    _require_dense(cfg)
    d = cfg.d_model
    unit = {f"l{i}": _sub_block_specs(cfg) for i in range(len(cfg.layer_pattern))}
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "fsdp"), init="embed", scale=0.02),
        "blocks": stack_specs(unit, num_units(cfg)),
        "ln_f": norm_specs(cfg, d),
    }


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
    return {f"l{i}": dict(kv) for i in range(len(cfg.layer_pattern))}


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
):
    """pre-LN attention + mlp; returns (x, new_cache)."""
    h, new_cache = attention_block(
        lp["attn"], apply_norm(lp["ln_attn"], x, cfg), positions, cfg,
        layer_type=layer_type, cache=lcache,
    )
    x = x + h
    h2 = apply_mlp(lp["mlp"], apply_norm(lp["ln_mlp"], x, cfg), cfg)
    return x + h2, new_cache


def decoder_forward(
    params: Dict,
    tokens: torch.Tensor,  # (B, S) int32
    cfg: ModelConfig,
    *,
    cache: Optional[Dict] = None,
    cache_len=None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss); a dense layer adds no
    auxiliary loss, so aux_loss is 0.

    With ``cache`` (a tree from ``cache_specs`` plus ``"len"``), the new
    tokens' k and v are written into its tensors in place and the returned
    cache holds the same tensors with ``len + S``.  ``cache_len`` (an int or
    a 0-dim tensor) is the first token's position.
    """
    _require_dense(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.adtype)
    start = 0 if cache_len is None else int(cache_len)
    x = shard(x, "batch", "residual_seq", None)
    positions = torch.arange(start, start + S, dtype=torch.int32, device=x.device)
    positions = positions[None].expand(B, S)

    blocks = params["blocks"]
    new_cache = None
    if cache is not None:
        clen = int(cache["len"])
        new_cache = {f"l{i}": {"k": cache[f"l{i}"]["k"], "v": cache[f"l{i}"]["v"]}
                     for i in range(len(cfg.layer_pattern))}
        new_cache["len"] = clen + S
    for u in range(num_units(cfg)):
        up = _tree_index(blocks, u)
        for i, lt in enumerate(cfg.layer_pattern):
            lc = None
            if cache is not None:
                lc = {"k": cache[f"l{i}"]["k"][u], "v": cache[f"l{i}"]["v"][u], "len": clen}
            x, _ = _one_layer(up[f"l{i}"], x, positions, cfg, lt, lc)

    x = apply_norm(params["ln_f"], x, cfg)
    x = shard(x, "batch", "residual_seq", None)
    logits = x @ params["embed"].T.to(cfg.adtype)  # tied head
    logits = softcap(logits.float(), cfg.logit_softcap)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard(logits, "batch", "residual_seq", "vocab"), new_cache, aux


class _Tree(nn.Module):
    """One dict of the parameter tree: leaves as parameters (no gradient),
    dicts as child modules, under the reference's keys."""

    def __init__(self, tree: Dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> Dict:
        out: Dict[str, Any] = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class DecoderLM(_Tree):
    """The dense decoder as an ``nn.Module``: ``params`` (a tree from
    ``materialize(decoder_specs(cfg), ...)`` or ``params_from_numpy``) held
    under the reference's paths, so that ``state_dict()`` keys are those
    paths joined by dots (``blocks.l0.attn.wq``).  ``forward`` is
    :func:`decoder_forward` on ``tree()``."""

    def __init__(self, cfg: ModelConfig, params: Dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens: torch.Tensor, cache: Optional[Dict] = None):
        return decoder_forward(
            self.tree(), tokens, self.cfg, cache=cache,
            cache_len=None if cache is None else cache["len"],
        )
