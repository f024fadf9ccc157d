"""Uniform model API — counterpart of ``repro.models.registry``: every
architecture exposes

    param_specs                    -> ParamSpec tree
    loss_fn(params, batch)         -> (loss, metrics)
    prefill_fn(params, batch)      -> logits of the last position
    decode_fn(params, cache, batch)-> (logits, new_cache)
    batch_specs(shape)             -> input ParamSpec tree
    cache_decl(shape)              -> cache ParamSpec tree + scalar "len"

Every family is ported: the dense and the MoE decoder, the VLM (patch
embeddings ahead of the text), the encoder-decoder, mamba2 (``ssm``) and
zamba2 (``hybrid``).
``loss_fn`` is differentiable (the training path, ``launch.steps``, takes
its gradients with ``torch.autograd``); ``prefill_fn`` and ``decode_fn``
are called under ``torch.inference_mode()`` by the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..runtime.sharding import ParamSpec
from . import ssm as ssm_mod
from . import transformer as tf_mod

__all__ = ["AUX_WEIGHT", "ModelAPI", "build_model", "cross_entropy"]

AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE; labels < 0 are ignored.  logits (B,S,V) f32, labels (B,S)."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    return nll.sum() / denom, denom


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    param_specs: Dict
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    batch_specs: Callable[[ShapeConfig], Dict]
    cache_decl: Callable[[ShapeConfig], Dict]


def _lm_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    tok = ("batch", "seq")
    if shape.kind == "train":
        return {
            "tokens": ParamSpec((B, S), tok, torch.int32),
            "labels": ParamSpec((B, S), tok, torch.int32),
        }
    if shape.kind == "prefill":
        return {"tokens": ParamSpec((B, S), tok, torch.int32)}
    # decode: one new token against a cache of length S
    return {"tokens": ParamSpec((B, 1), ("batch", None), torch.int32)}


def _vlm_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    base = _lm_batch_specs(cfg, shape)
    if shape.kind in ("train", "prefill"):
        B = shape.global_batch
        P = cfg.frontend_len
        S_text = shape.seq_len - P
        base["tokens"] = ParamSpec((B, S_text), ("batch", "seq"), torch.int32)
        if "labels" in base:
            base["labels"] = ParamSpec((B, S_text), ("batch", "seq"), torch.int32)
        base["patches"] = ParamSpec((B, P, cfg.frontend_dim), ("batch", None, None), torch.float32)
    return base


def _src_len(cfg: ModelConfig, seq_len: int) -> int:
    """An encoder-decoder's source frames for ``seq_len`` target tokens."""
    return max(seq_len // cfg.src_ratio, 16)


def _encdec_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    base = _lm_batch_specs(cfg, shape)
    if shape.kind in ("train", "prefill"):
        base["frames"] = ParamSpec((B, _src_len(cfg, S), cfg.frontend_dim),
                                   ("batch", "seq", None), torch.float32)
    return base


def _build_decoder_family(cfg: ModelConfig) -> ModelAPI:
    specs = tf_mod.decoder_specs(cfg)
    is_vlm = cfg.family == "vlm"
    is_encdec = cfg.family == "encdec"

    def frontend_kw(params, batch) -> Dict:
        """decoder_forward's keywords for the batch's frontend input: the
        VLM's patches, or the encoder-decoder's encoder output and source
        positions."""
        if is_vlm:
            return {"patches": batch["patches"]}
        if is_encdec:
            enc_out = tf_mod.encoder_forward(params, batch["frames"], cfg)
            B, Ssrc = enc_out.shape[:2]
            src = torch.arange(Ssrc, dtype=torch.int32, device=enc_out.device)
            return {"enc_out": enc_out, "src_positions": src[None].expand(B, Ssrc)}
        return {}

    def loss_fn(params, batch):
        logits, _, aux = tf_mod.decoder_forward(params, batch["tokens"], cfg,
                                                **frontend_kw(params, batch))
        if is_vlm:
            logits = logits[:, cfg.frontend_len:]
        loss, ntok = cross_entropy(logits, batch["labels"])
        total = loss + AUX_WEIGHT * aux
        return total, {"ce": loss, "aux": aux, "ntok": ntok}

    def prefill_fn(params, batch):
        logits, _, _ = tf_mod.decoder_forward(params, batch["tokens"], cfg,
                                              **frontend_kw(params, batch))
        return logits[:, -1:]

    def decode_fn(params, cache, batch):
        """One step; writes the new k and v into ``cache`` in place."""
        logits, new_cache, _ = tf_mod.decoder_forward(
            params, batch["tokens"], cfg, cache=cache, cache_len=cache["len"]
        )
        return logits, new_cache

    def cache_decl(shape: ShapeConfig):
        src_len = _src_len(cfg, shape.seq_len) if is_encdec else 0
        decl = tf_mod.cache_specs(cfg, shape.global_batch, shape.seq_len, src_len=src_len)
        decl["len"] = ParamSpec((), (), torch.int32, "zeros")
        return decl

    bspecs = (
        _vlm_batch_specs if is_vlm else _encdec_batch_specs if is_encdec else _lm_batch_specs
    )
    return ModelAPI(
        cfg, specs, loss_fn, prefill_fn, decode_fn,
        lambda s: bspecs(cfg, s), cache_decl,
    )


def _build_mamba(cfg: ModelConfig) -> ModelAPI:
    specs = ssm_mod.mamba_specs(cfg)

    def loss_fn(params, batch):
        logits, _, _ = ssm_mod.mamba_forward(params, batch["tokens"], cfg)
        loss, ntok = cross_entropy(logits, batch["labels"])
        return loss, {"ce": loss, "ntok": ntok}

    def prefill_fn(params, batch):
        logits, _, _ = ssm_mod.mamba_forward(params, batch["tokens"], cfg)
        return logits[:, -1:]

    def decode_fn(params, cache, batch):
        """One step; returns a new cache (``conv`` and ``state`` replaced)."""
        logits, new_cache, _ = ssm_mod.mamba_forward(params, batch["tokens"], cfg, cache=cache)
        return logits, new_cache

    def cache_decl(shape: ShapeConfig):
        return ssm_mod.mamba_cache_specs(cfg, shape.global_batch)

    return ModelAPI(
        cfg, specs, loss_fn, prefill_fn, decode_fn,
        lambda s: _lm_batch_specs(cfg, s), cache_decl,
    )


def _build_zamba(cfg: ModelConfig) -> ModelAPI:
    specs = ssm_mod.zamba_specs(cfg)

    def loss_fn(params, batch):
        logits, _, _ = ssm_mod.zamba_forward(params, batch["tokens"], cfg)
        loss, ntok = cross_entropy(logits, batch["labels"])
        return loss, {"ce": loss, "ntok": ntok}

    def prefill_fn(params, batch):
        logits, _, _ = ssm_mod.zamba_forward(params, batch["tokens"], cfg)
        return logits[:, -1:]

    def decode_fn(params, cache, batch):
        """One step; the SSD layers' ``conv`` and ``state`` come back new,
        the shared block's k and v are written into ``cache`` in place."""
        logits, new_cache, _ = ssm_mod.zamba_forward(
            params, batch["tokens"], cfg, cache=cache, cache_len=cache["len"]
        )
        return logits, new_cache

    def cache_decl(shape: ShapeConfig):
        decl = ssm_mod.zamba_cache_specs(cfg, shape.global_batch, shape.seq_len)
        decl["len"] = ParamSpec((), (), torch.int32, "zeros")
        return decl

    return ModelAPI(
        cfg, specs, loss_fn, prefill_fn, decode_fn,
        lambda s: _lm_batch_specs(cfg, s), cache_decl,
    )


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "ssm":
        return _build_mamba(cfg)
    if cfg.family == "hybrid":
        return _build_zamba(cfg)
    return _build_decoder_family(cfg)
