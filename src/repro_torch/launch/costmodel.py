"""Analytic FLOPs / HBM-bytes model per (arch x shape) — the roofline's
compute and memory terms.  A copy of ``repro.launch.costmodel`` (pure
arithmetic over configs), kept as it is so the two packages' dry-runs
compare cell for cell; its notes on XLA are the reference's.

Why analytic: XLA's HloCostAnalysis counts a `while` body ONCE, not
x trip-count, so compiled.cost_analysis() under-reports any scanned-layer
model by ~num_units (verified on gemma2-2b: raw 2.05e13 flops/chip vs
analytic 9.1e13 — ratio == the 13-unit scan).  We therefore derive the
compute/memory terms from explicit formulas over the architecture configs
(every matmul in the model is enumerated below) and keep the raw XLA numbers
in the artifact for reference.  Collective bytes DO come from the compiled
HLO — with while-trip multipliers (hlo_analysis.collective_bytes_tripaware).

Conventions:
  fwd FLOPs — 2*m*n*k per matmul, global (whole step, all chips).
  train = 4x layer fwd (fwd + 2x bwd + 1x remat recompute) + 3x logits.
  bytes — HBM traffic estimate: weight reads per use, activation
  boundaries, optimizer state read/write, KV/state cache traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..configs.base import ModelConfig, ShapeConfig


@dataclass
class CellCost:
    fwd_flops: float
    total_flops: float          # per step, global
    hbm_bytes: float            # per step, global
    model_flops: float          # 6*N_active*D (train) / 2*N_active*D (fwd)
    param_count: float
    active_param_count: float
    notes: str = ""


def _attn_ctx(S: int, layer_type: str, window: int, kind: str) -> float:
    """Average attended length per query."""
    if kind == "decode":
        return float(S)  # one query against the whole cache
    full = S / 2.0  # causal average
    if layer_type == "local":
        return float(min(window, full))
    return full


def _attn_flops(cfg: ModelConfig, T: float, S: int, kind: str, layer_type: str) -> float:
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model
    proj = 2 * T * d * (H * hd + 2 * KV * hd) + 2 * T * (H * hd) * d
    ctx = _attn_ctx(S, layer_type, cfg.window_size, kind)
    core = 2 * 2 * T * H * hd * ctx
    return proj + core


def _mlp_flops(cfg: ModelConfig, T: float, ff: int) -> float:
    nmat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    return 2 * T * cfg.d_model * ff * nmat


def _moe_flops(cfg: ModelConfig, T: float) -> float:
    d, E, k, eff = cfg.d_model, cfg.num_experts, cfg.experts_per_tok, cfg.expert_d_ff
    router = 2 * T * d * E
    rows = T * k * cfg.capacity_factor
    nmat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    experts = 2 * rows * d * eff * nmat
    shared = _mlp_flops(cfg, T, eff * cfg.shared_experts) if cfg.shared_experts else 0
    return router + experts + shared


def _ssd_flops(cfg: ModelConfig, T: float, kind: str) -> float:
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    proj = 2 * T * d * (2 * di + 2 * N + H) + 2 * T * di * d
    conv = 2 * T * (di + 2 * N) * cfg.ssm_conv
    Q = cfg.ssm_chunk if kind != "decode" else 1
    core = T * (2 * Q * N + 2 * Q * di + 4 * N * di)
    return proj + conv + core


def _param_counts(cfg: ModelConfig) -> Dict[str, float]:
    d, V = cfg.d_model, cfg.vocab_size
    embed = V * d  # tied head
    per_attn = d * (cfg.num_heads * cfg.hd + 2 * cfg.num_kv_heads * cfg.hd) + (
        cfg.num_heads * cfg.hd
    ) * d
    nmat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    per_mlp = nmat * d * cfg.d_ff
    per_moe = (
        d * cfg.num_experts
        + nmat * cfg.num_experts * d * cfg.expert_d_ff
        + (nmat * d * cfg.expert_d_ff * cfg.shared_experts)
    )
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim if di else 0
    per_ssd = (
        d * (2 * di + 2 * N + H) + di * d + cfg.ssm_conv * (di + 2 * N) if di else 0
    )
    total = embed
    active = embed
    L = cfg.num_layers
    if cfg.family in ("dense", "vlm", "encdec"):
        total += L * (per_attn + per_mlp)
        active = total
        if cfg.family == "encdec":
            total += cfg.encoder_layers * (per_attn + per_mlp) + L * per_attn  # xattn
            total += cfg.frontend_dim * d
            active = total
        if cfg.family == "vlm":
            total += cfg.frontend_dim * d
            active = total
    elif cfg.family == "moe":
        dense_layers = cfg.first_k_dense
        moe_layers = L - dense_layers
        total += L * per_attn + dense_layers * per_mlp + moe_layers * per_moe
        active_moe = (
            d * cfg.num_experts
            + nmat * cfg.experts_per_tok * d * cfg.expert_d_ff
            + nmat * d * cfg.expert_d_ff * cfg.shared_experts
        )
        active = embed + L * per_attn + dense_layers * per_mlp + moe_layers * active_moe
    elif cfg.family == "ssm":
        total += L * per_ssd
        active = total
    elif cfg.family == "hybrid":
        shared = (2 * d) * d + per_attn + per_mlp
        total += L * per_ssd + shared
        # shared block params are REUSED every application: active compute uses
        # them (num_layers // every) times but memory holds them once
        active = total
    return {"total": total, "active": active}


def analytic_costs(cfg: ModelConfig, shape: ShapeConfig) -> CellCost:
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    Sq = 1 if kind == "decode" else S
    T = float(B * Sq)
    d, V = cfg.d_model, cfg.vocab_size
    L = cfg.num_layers

    fwd = 0.0
    logits = 2 * T * d * V
    if cfg.family in ("dense", "vlm", "moe", "encdec"):
        if cfg.family == "vlm" and kind != "decode":
            T = float(B * (Sq))  # patch tokens already inside seq_len budget
        pat = cfg.layer_pattern
        for li in range(L):
            lt = pat[li % len(pat)]
            fwd += _attn_flops(cfg, T, S, kind, lt)
            if cfg.family == "moe" and li >= cfg.first_k_dense:
                fwd += _moe_flops(cfg, T)
            else:
                fwd += _mlp_flops(cfg, T, cfg.d_ff if cfg.d_ff else cfg.expert_d_ff)
        if cfg.family == "encdec":
            Tsrc = float(B * max(S // cfg.src_ratio, 16)) if kind != "decode" else 0.0
            Ssrc = max(S // cfg.src_ratio, 16)
            H, hd = cfg.num_heads, cfg.hd
            for _ in range(cfg.encoder_layers):
                if Tsrc:
                    # bidirectional: every query attends the full source
                    proj = 2 * Tsrc * d * (H * hd + 2 * cfg.num_kv_heads * hd) + 2 * Tsrc * H * hd * d
                    fwd += proj + 2 * 2 * Tsrc * H * hd * Ssrc
                    fwd += _mlp_flops(cfg, Tsrc, cfg.d_ff)
            # cross attention in every decoder layer
            xctx = Ssrc
            fwd += L * (2 * T * d * (cfg.num_heads * cfg.hd) + 2 * 2 * T * cfg.num_heads * cfg.hd * xctx)
    elif cfg.family == "ssm":
        fwd += L * _ssd_flops(cfg, T, kind)
    elif cfg.family == "hybrid":
        fwd += L * _ssd_flops(cfg, T, kind)
        napp = L // cfg.shared_attn_every
        shared = (
            2 * T * (2 * d) * d
            + _attn_flops(cfg, T, S, kind, "global")
            + _mlp_flops(cfg, T, cfg.d_ff)
        )
        fwd += napp * shared
    fwd += logits

    if kind == "train":
        total = 4.0 * (fwd - logits) + 3.0 * logits
    else:
        total = fwd

    # ---- bytes ----
    pc = _param_counts(cfg)
    pbytes = pc["total"] * 2.0  # bf16
    act_io = 2.0  # bf16
    if kind == "train":
        opt_bytes = pc["total"] * (8.0 if cfg.optimizer == "adamw" else 0.1)
        # params: fwd + recompute + bwd reads, grad write+read, param write
        traffic = pbytes * 5.0 + opt_bytes * 2.0
        # activation boundaries: ~10 tensor r/w of (T, d) per layer
        traffic += L * T * d * act_io * 10.0
        traffic += T * V * 4.0 * 2.0  # logits fwd+bwd
    elif kind == "prefill":
        traffic = pbytes + L * T * d * act_io * 6.0 + T * V * 4.0
    else:  # decode: weight-read bound + cache read
        traffic = pbytes + T * V * 4.0
        if cfg.family in ("dense", "vlm", "moe", "encdec"):
            cache = L * B * S * cfg.num_kv_heads * cfg.hd * 2 * 2.0
            traffic += cache
        if cfg.family in ("ssm", "hybrid"):
            di, N = cfg.ssm_d_inner, cfg.ssm_state
            H = di // cfg.ssm_head_dim
            traffic += L * B * H * N * cfg.ssm_head_dim * 4.0 * 2.0
            if cfg.family == "hybrid":
                napp = L // cfg.shared_attn_every
                traffic += napp * B * S * cfg.num_kv_heads * cfg.hd * 2 * 2.0

    tokens = T
    mf = (6.0 if kind == "train" else 2.0) * pc["active"] * tokens
    return CellCost(
        fwd_flops=fwd,
        total_flops=total,
        hbm_bytes=traffic,
        model_flops=mf,
        param_count=pc["total"],
        active_param_count=pc["active"],
    )
