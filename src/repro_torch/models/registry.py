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
from ..runtime.sharding import ParamSpec, replicate_like, shard
from . import ssm as ssm_mod
from . import transformer as tf_mod

__all__ = ["AUX_WEIGHT", "ModelAPI", "build_model", "cross_entropy"]

AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE; labels < 0 are ignored.  logits (B,S,V) f32, labels (B,S).
    DTensor logits take ``_vocab_parallel_ce``."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return _vocab_parallel_ce(logits, labels)
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    return nll.sum() / denom, denom


def _vocab_parallel_ce(logits, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cross_entropy`` of DTensor logits without gathering them: a
    ``shard_map`` island over the logits in the layout they arrive in
    (split on the batch, sequence and vocabulary dims as the rules left
    them: moving a split from one dim to another would gather a whole dim
    of them on every rank), the labels split alike.  Each rank takes its
    vocabulary slice's max (all-reduced, held constant: the log-sum-exp's
    gradient does not depend on it), its sum of exponentials and the gold
    logits that fall in its slice, each psum'd over the vocabulary's axes;
    the masked NLL and the token count are psum'd over the batch and
    sequence axes."""
    from ..runtime import collectives as coll
    from ..runtime.sharding import current_rules, entry_axes, shard_map, spec_for, spec_of

    mesh = logits.device_mesh
    lspec = spec_of(logits)
    if lspec is None:  # a partial sum: reduced on the way in
        lspec = spec_for(logits.shape, ("batch", None, "vocab"), mesh, current_rules())
    yspec = lspec[:2]
    vocab_axes = entry_axes(lspec[2])
    token_axes = entry_axes(lspec[0]) + entry_axes(lspec[1])

    def body(lg, y):
        V = lg.shape[-1]
        off = coll.flat_index(mesh, vocab_axes) * V  # this rank's slice of the vocabulary
        m = coll.pmax(lg.detach().amax(-1), mesh, vocab_axes)
        se = coll.psum(torch.exp(lg - m[..., None]).sum(-1), mesh, vocab_axes)
        logz = m + torch.log(se)
        mask = (y >= 0).float()
        safe = y.clamp_min(0).long()
        mine = (safe >= off) & (safe < off + V)
        idx = (safe - off).clamp(0, V - 1)
        gold = coll.psum(torch.where(mine, torch.take_along_dim(lg, idx[..., None], dim=-1)[..., 0],
                                     0.0), mesh, vocab_axes)
        nll = coll.psum(((logz - gold) * mask).sum(), mesh, token_axes)
        denom = coll.psum(mask.sum(), mesh, token_axes)
        return nll, denom

    nll, denom = shard_map(mesh, body, (None, None), (logits, labels), in_specs=(lspec, yspec),
                           split_axes=token_axes + vocab_axes)
    denom = denom.clamp_min(1.0)
    return nll / denom, denom


def _last_position(logits: torch.Tensor) -> torch.Tensor:
    """``logits[:, -1:]``.  DTensor logits split on the sequence are read in
    a ``shard_map`` island (the last shard's last row, psum'd over the
    sequence's axes), where a plain slice would gather the whole sequence
    of logits on every rank."""
    from torch.distributed.tensor import DTensor

    from ..runtime import collectives as coll
    from ..runtime.sharding import entry_axes, shard_map, spec_of

    spec = spec_of(logits) if isinstance(logits, DTensor) else None
    seq_axes = entry_axes(spec[1]) if spec is not None else ()
    if not seq_axes:
        return logits[:, -1:]
    mesh = logits.device_mesh

    def body(lg):
        last = coll.flat_index(mesh, seq_axes) == coll.axis_size(mesh, seq_axes) - 1
        row = lg[:, -1:]
        return coll.psum(row if last else torch.zeros_like(row), mesh, seq_axes)

    return shard_map(mesh, body, ((spec[0], None, spec[2]),), (logits,), in_specs=(spec,))


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
            src = shard(replicate_like(src[None].expand(B, Ssrc), enc_out), "batch", None)
            return {"enc_out": enc_out, "src_positions": src}
        return {}

    def loss_fn(params, batch):
        from torch.distributed.tensor import DTensor

        logits, _, aux = tf_mod.decoder_forward(params, batch["tokens"], cfg,
                                                **frontend_kw(params, batch))
        labels = batch["labels"]
        if is_vlm and isinstance(logits, DTensor):
            # the patch positions' labels masked, where slicing them off the
            # logits would gather the sequence on every rank
            pad = torch.full((labels.shape[0], cfg.frontend_len), -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([shard(replicate_like(pad, labels), "batch", None), labels], dim=1)
        elif is_vlm:
            logits = logits[:, cfg.frontend_len:]
        loss, ntok = cross_entropy(logits, labels)
        total = loss + AUX_WEIGHT * aux
        return total, {"ce": loss, "aux": aux, "ntok": ntok}

    def prefill_fn(params, batch):
        logits, _, _ = tf_mod.decoder_forward(params, batch["tokens"], cfg,
                                              **frontend_kw(params, batch))
        return _last_position(logits)

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
        return _last_position(logits)

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
        return _last_position(logits)

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
