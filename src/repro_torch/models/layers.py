"""Shared neural layers: norms, RoPE, chunked flash-style attention
(prefill / decode), dense MLPs, the MoE (the dense dispatch, and under a
mesh the expert-parallel all-to-all island or the replicated-token island,
``local_map`` bodies over the mesh's sub-groups) and the Mamba2 SSD block
— counterpart of ``repro.models.layers``.  Under an ``axis_rules`` mesh
every layer runs on DTensors, and ``shard`` sets their layouts as the
reference's sharding constraints do.  Every layer is differentiable: the
training path takes gradients through the chunked attention's online
softmax as it is written (a fully masked chunk contributes exact zeros,
never NaN), through the MoE's bins (a dropped route's gradient is zero)
and through the SSD's chunked scan (its causal mask is applied in log
space before the ``exp``, so no ``inf`` reaches a gradient).

All layers are plain functions over ParamSpec-declared trees of tensors, in
plain PyTorch ops.  The reference's dtypes follow JAX promotion; where
PyTorch would differ, the cast is written out:

* weights are bf16 whatever ``cfg.dtype`` is, and ``x @ w`` promotes to the
  activation dtype (``_mm`` casts the weight);
* a Python scalar times a bf16 array is a bf16 product of the scalar
  rounded to bf16 (JAX's weak typing), so ``q``'s scale is rounded to
  ``q``'s dtype first;
* scores leave the einsum in the activation dtype and go to f32 for the
  softcap, the mask and the softmax; the probabilities go back to ``v``'s
  dtype for the PV product, and the chunked branch's accumulator lives in
  ``v``'s dtype across chunks;
* norms and RoPE compute in f32 and cast back;
* GELU is the tanh approximation (``jax.nn.gelu``'s default) and SiLU is
  ``x * sigmoid(x)``, both op for op as JAX and XLA write them: in bf16
  every op rounds, where PyTorch's fused ``F.gelu``/``F.silu`` round once;
  the sigmoid's gradient is the logistic's own, as JAX's is.

Division is by 0-dim tensors, not Python floats: on CUDA PyTorch turns
``x / c`` into ``x * (1 / c)``, which is not the quotient.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..runtime import collectives as coll
from ..runtime.sharding import (ParamSpec, contiguous_strides, current_mesh, current_rules,
                                entry_axes, mesh_sizes, shard, shard_map, spec_for)

__all__ = [
    "NEG_INF", "Routing", "apply_mlp", "apply_moe", "apply_norm", "apply_ssd",
    "attention_block", "attention_specs", "embed_lookup", "mlp_specs", "moe_specs",
    "multihead_attention", "norm_specs", "recording_routes", "rope", "softcap", "ssd_specs",
]

NEG_INF = -1e30
# unwritten cache slots and padded keys sit at this position; a key is valid
# below 2**29
FAR = 2**30


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true quotient on every device (the 0-dim divisor is
    filled on the device: a tensor built from a Python number would be a
    synchronous host-to-device copy)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s promotion: an f32 query meets a bf16 cache as f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return _ein(eq, a.to(dt), b.to(dt))


def _ein(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)``; on DTensors ``_dt_einsum``."""
    if _is_dtensor(a) or _is_dtensor(b):
        return _dt_einsum(eq, a, b)
    return torch.einsum(eq, a, b)


def _dt_einsum(eq: str, a, b):
    """A two-operand einsum of DTensors computed on the local shards.

    For each mesh axis the operands are brought to one sharded letter (the
    one either is sharded on; where they are sharded on different letters,
    the cheaper choice: the elements of the operand gathered on that axis,
    plus the output's if the kept letter is summed over), the other
    operand is split on that letter too where it has it (a local slice),
    and the local einsum runs.  A letter the output keeps stays sharded; a
    contracted one is summed over its axis (``collectives.psum``; in
    float32 for 16-bit operands, rounded once after the sum).  An
    operand replicated on an axis where the work is split receives a
    partial gradient there.  DTensor's own einsum flattens sharded dims
    into strided shards, which torch 2.11 refuses for the attention's
    products and which cost a graph search on a 3-axis mesh."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = eq.split("->")
    la, lb = ins.split(",")
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    a, b = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (a, b))

    def unpartial(t):
        if any(q.is_partial() for q in t.placements):
            return t.redistribute(mesh, [Replicate() if q.is_partial() else q
                                         for q in t.placements])
        return t

    a, b = unpartial(a), unpartial(b)
    size = dict(zip(la, a.shape))
    size.update(zip(lb, b.shape))
    n_out = int(np.prod([size[c] for c in out]))

    def cost(letter, gathered):  # elements gathered, plus the output if it is summed
        return gathered.numel() + (0 if letter in out else n_out)

    pa, pb, po, summed = [], [], [], []
    for m, (qa, qb) in enumerate(zip(a.placements, b.placements)):
        xa = la[qa.dim] if isinstance(qa, Shard) else None
        xb = lb[qb.dim] if isinstance(qb, Shard) else None
        if xa and xb and xa != xb:
            if cost(xa, b) <= cost(xb, a):
                xb = None
            else:
                xa = None
        letter = xa or xb
        if letter is None:
            pa.append(Replicate())
            pb.append(Replicate())
            po.append(Replicate())
            continue
        pa.append(Shard(la.index(letter)) if letter in la else Replicate())
        pb.append(Shard(lb.index(letter)) if letter in lb else Replicate())
        if letter in out:
            po.append(Shard(out.index(letter)))
        else:
            po.append(Replicate())
            summed.append(m)
    a = a if tuple(a.placements) == tuple(pa) else a.redistribute(mesh, pa)
    b = b if tuple(b.placements) == tuple(pb) else b.redistribute(mesh, pb)
    split = [any(isinstance(q, Shard) for q in qs) for qs in zip(pa, pb)]

    def grad_pl(pl):
        return [Partial() if isinstance(q, Replicate) and split[m] else q
                for m, q in enumerate(pl)]

    la_t = a.to_local(grad_placements=grad_pl(pa))
    lb_t = b.to_local(grad_placements=grad_pl(pb))
    names = list(mesh.mesh_dim_names)
    if summed and a.dtype.itemsize < 4:
        # a split contraction in a 16-bit dtype: the partial sums in float32
        # and rounded once after the psum, as the unsplit product rounds
        dt = torch.promote_types(a.dtype, b.dtype)
        res = coll.psum(torch.einsum(eq, la_t.float(), lb_t.float()), mesh,
                        [names[m] for m in summed]).to(dt)
    else:
        res = torch.einsum(eq, la_t, lb_t)
        if summed:
            res = coll.psum(res, mesh, [names[m] for m in summed])
    shape = torch.Size([size[c] for c in out])
    return DTensor.from_local(res.contiguous(), mesh, po, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table split over its vocabulary (the
    ``"vocab"`` rule) is read in a ``shard_map`` island: each rank looks
    up the tokens that fall in its slice (zeros for the rest) and one psum
    over the vocabulary's axes completes the rows, where a plain index
    would gather the whole table on every rank."""
    if not _is_dtensor(table):
        return table[tokens]
    mesh = table.device_mesh
    tspec = spec_for(table.shape, ("vocab", None), mesh, current_rules())
    kspec = spec_for(tokens.shape, ("batch", None), mesh, current_rules())
    vocab_axes, batch_axes = entry_axes(tspec[0]), entry_axes(kspec[0])

    def body(tab, tok):
        V = tab.shape[0]
        local = tok.long() - coll.flat_index(mesh, vocab_axes) * V  # this rank's slice
        mine = (local >= 0) & (local < V)
        rows = tab[local.clamp(0, V - 1)] * mine[..., None].to(tab.dtype)
        return coll.psum(rows, mesh, vocab_axes)

    return shard_map(mesh, body, ((kspec[0], None, None),), (table, tokens),
                     in_specs=(tspec, kspec), split_axes=batch_axes + vocab_axes)


def _const(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as JAX rounds a weak Python scalar."""
    return torch.tensor(c, dtype=dtype).item()


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the reference's promotion: a bf16 weight meets an f32
    activation as f32.

    On DTensors it is ``_dt_einsum``: ``matmul`` would flatten B and S into
    one dim, and with both sharded (batch and Megatron-SP seq) DTensor's
    layout for that dim is a strided shard, which it can neither plan
    quickly nor under the dry-run's fake tensors."""
    w = w.to(x.dtype)
    if _is_dtensor(x) or _is_dtensor(w):
        lead = "abc"[:x.ndim - 1]
        return _dt_einsum(f"{lead}y,yz->{lead}z", x, w)
    return x @ w


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_specs(cfg: ModelConfig, d: int) -> Dict:
    if cfg.norm == "layernorm":
        return {
            "scale": ParamSpec((d,), (None,), torch.float32, "ones"),
            "bias": ParamSpec((d,), (None,), torch.float32, "zeros"),
        }
    return {"scale": ParamSpec((d,), (None,), torch.float32, "ones")}


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(_div(x, cap)) * cap
    return x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _rope_freqs(half: int, theta: float, device: torch.device) -> torch.Tensor:
    # numpy's float32 arithmetic, as the reference computes them, copied to
    # the device once
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(freqs, dtype=np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) int32."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": ParamSpec((d, H * hd), ("fsdp", "qkv")),
        "wk": ParamSpec((d, KV * hd), ("fsdp", "qkv")),
        "wv": ParamSpec((d, KV * hd), ("fsdp", "qkv")),
        "wo": ParamSpec((H * hd, d), ("qkv", "fsdp")),
    }
    if cfg.qk_norm:
        p["qnorm"] = {"scale": ParamSpec((hd,), (None,), torch.float32, "ones")}
        p["knorm"] = {"scale": ParamSpec((hd,), (None,), torch.float32, "ones")}
    return p


def _qk_normalize(p, q, k, cfg):
    if not cfg.qk_norm:
        return q, k

    def rn(scale, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)

    return rn(p["qnorm"]["scale"], q), rn(p["knorm"]["scale"], k)


def _chunk_mask(qpos, kpos, layer_type: str, window: int, causal: bool):
    """(..., Sq, Sk) boolean mask given absolute positions (..., Sq) and
    (..., Sk)."""
    diff = qpos[..., :, None] - kpos[..., None, :]
    m = (kpos < 2**29)[..., None, :]  # padded / unwritten cache slots are invalid
    if causal:
        m = m & (diff >= 0)
    if layer_type == "local":
        m = m & (diff < window)
    return m


def multihead_attention(
    x_q: torch.Tensor,       # (B, Sq, H, hd) post-rope
    k: torch.Tensor,         # (B, Sk, KV, hd)
    v: torch.Tensor,         # (B, Sk, KV, hd)
    qpos: torch.Tensor,      # (B, Sq)
    kpos: torch.Tensor,      # (B, Sk)
    *,
    layer_type: str = "global",
    window: int = 0,
    causal: bool = True,
    attn_softcap: float = 0.0,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax (flash-style) chunked attention over key blocks.

    Peak memory is (B, H, Sq, kv_chunk) scores, never (Sq, Sk); GQA reshapes
    q into (KV, group) without repeating K/V.  ``Sq <= 8`` (decode) takes
    the direct split-K form over all keys at once.
    """
    B, Sq, H, hd = x_q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    q = _unflatten(x_q, 2, (KV, G)) * _const(hd ** -0.5, x_q.dtype)

    if Sq <= 8:
        s = _einsum("bqkgh,bskh->bkgqs", q, k).float()
        s = softcap(s, attn_softcap)
        mask = _chunk_mask(qpos, kpos, layer_type, window, causal)  # (B, Sq, Sk)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        pexp = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
        l = pexp.sum(-1, keepdim=True)
        out = _ein("bkgqs,bskh->bkgqh", (pexp / l.clamp_min(1e-30)).to(v.dtype), v)
        return out.movedim(3, 1).reshape(B, Sq, H, hd)

    # keys shorter than a chunk take one chunk of their own length: the
    # reference pads them to kv_chunk, and padded keys add exact zeros
    kv_chunk = min(kv_chunk, Sk)
    nchunks = -(-Sk // kv_chunk)
    pad = nchunks * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=FAR)
    # the running max, sum and output start as the first chunk's: from the
    # reference's NEG_INF, 0 and 0 the first update gives exactly these
    # (max(NEG_INF, s) = s, 0 * alpha + x = x), and no tensor is made
    # outside the data's own layout
    m_run = l_run = acc = None
    for c in range(nchunks):
        blk = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kb, vb, pb = k[:, blk], v[:, blk], kpos[:, blk]
        s = _einsum("bqkgh,bckh->bkgqc", q, kb).float()
        s = softcap(s, attn_softcap)
        mask = _chunk_mask(qpos, pb, layer_type, window, causal)  # (B, Sq, C)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = s.amax(-1) if m_run is None else torch.maximum(m_run, s.amax(-1))
        # fully-masked chunks: exp(NEG_INF - NEG_INF) would be 1 — force 0
        pexp = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m_new[..., None]))
        upd = _ein("bkgqc,bckh->bkgqh", pexp.to(vb.dtype), vb)
        if m_run is None:
            l_run, acc = pexp.sum(-1), upd
        else:
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None].to(acc.dtype) + upd
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None].to(acc.dtype)
    return out.movedim(3, 1).reshape(B, Sq, H, hd)  # (B,KV,G,Sq,hd) -> (B,Sq,H,hd)


def _unflatten(t: torch.Tensor, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``t`` with dim ``dim`` split into ``sizes``.  A DTensor split on that
    dim finer than ``sizes[0]`` (a 16-way split of 4 heads) is gathered on
    it first: DTensor cannot view a shard boundary that falls inside the
    outer dim, where GSPMD relayouts."""
    if _is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        split = [i for i, q in enumerate(t.placements) if isinstance(q, Shard) and q.dim == dim]
        if sizes[0] % int(np.prod([t.device_mesh.size(i) for i in split])):
            t = t.redistribute(t.device_mesh, [Replicate() if i in split else q
                                               for i, q in enumerate(t.placements)])
    return t.unflatten(dim, sizes)


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n hd) -> (B, S, n, hd)."""
    return _unflatten(t, t.ndim - 1, (n, hd))


def _write_slots(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """``dst[:, start:start + S] = src`` in place.  On a DTensor cache whose
    slot dim is sharded (``cache_seq``), ``src`` is brought to the cache's
    layout with that dim whole, and each rank writes the slots its own
    shard holds (the reference's ``dynamic_update_slice``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    S = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, start:start + S] = src
        return
    mesh = dst.device_mesh
    want = tuple(Replicate() if isinstance(q, Shard) and q.dim == 1 else q for q in dst.placements)
    src = src if isinstance(src, DTensor) else DTensor.from_local(
        src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src_l = src.redistribute(mesh, want).to_local()
    dst_l = dst.to_local()
    # the shard's first slot: dim 1 is split evenly (spec_for's rule) by
    # each of its mesh axes in turn, the mesh's outer axis first
    n, off = dst.shape[1], 0
    for i, q in enumerate(dst.placements):
        if isinstance(q, Shard) and q.dim == 1:
            n //= mesh.size(i)
            off += mesh.get_local_rank(i) * n
    lo, hi = max(start, off), min(start + S, off + n)
    if lo < hi:
        dst_l[:, lo - off:hi - off] = src_l[:, lo - start:hi - start]


def attention_block(
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    layer_type: str = "global",
    causal: bool = True,
    cache: Optional[Dict] = None,
    xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full attention sublayer: projections + rope + (cached) attention.

    cache: ``{"k": (B, T, KV, hd), "v": ..., "len": int}`` for decode.  The
    new k and v are written into the cache tensors in place (the reference
    donates its cache to the step, so the old one is gone there too); the
    returned dict holds the same tensors and ``len + S``.

    xattn_kv: precomputed ``(k, v, kpos)`` for cross-attention, taken as
    given: only q is projected, without RoPE (with ``qk_norm`` only q is
    normalized), and no cache is written.
    """
    B, S, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _split_heads(_mm(x, p["wq"]), H, hd)
    if xattn_kv is None:
        k = _split_heads(_mm(x, p["wk"]), KV, hd)
        v = _split_heads(_mm(x, p["wv"]), KV, hd)
        q, k = _qk_normalize(p, q, k, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        kpos = positions
    else:
        k, v, kpos = xattn_kv
        q, _ = _qk_normalize(p, q, q, cfg)
    q = shard(q, "batch", "q_seq", "heads", None)
    k = shard(k, "batch", "kv_seq", "kv_heads", None)
    v = shard(v, "batch", "kv_seq", "kv_heads", None)

    new_cache = None
    if cache is not None and xattn_kv is None:
        ck, cv = cache["k"], cache["v"]
        T = ck.shape[1]
        start = int(cache["len"])
        if start + S > T:
            raise ValueError(f"cache of {T} slots cannot take tokens {start}..{start + S - 1}")
        _write_slots(ck, k.to(ck.dtype), start)
        _write_slots(cv, v.to(cv.dtype), start)
        new_cache = {"k": ck, "v": cv, "len": start + S}
        k, v = ck, cv
        slots = torch.arange(T, dtype=torch.int32, device=x.device)
        # mask out unwritten slots via "future" positions
        kpos = torch.where(slots < start + S, slots, FAR)[None].expand(B, T)

    out = multihead_attention(
        q, k, v, positions, kpos,
        layer_type=layer_type,
        window=cfg.window_size,
        causal=causal,
        attn_softcap=cfg.attn_softcap,
    )
    out = shard(out, "batch", "q_seq", "heads", None)
    out = _mm(out.reshape(B, S, H * hd), p["wo"])
    return shard(out, "batch", "residual_seq", None), new_cache


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d: int, ff: int) -> Dict:
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, ff), ("fsdp", "ffn")),
            "w_in": ParamSpec((d, ff), ("fsdp", "ffn")),
            "w_out": ParamSpec((ff, d), ("ffn", "fsdp")),
        }
    return {
        "w_in": ParamSpec((d, ff), ("fsdp", "ffn")),
        "w_out": ParamSpec((ff, d), ("ffn", "fsdp")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (``approximate=True``), op for op."""
    c = _const(float(np.sqrt(2 / np.pi)), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + _const(0.044715, x.dtype) * (x * x * x))))
    return x * cdf


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: its value as XLA expands it, ``1 / (1 + exp(-x))``
    op for op, and its own derivative, ``g s (1 - s)``.  Autograd through
    the expansion would multiply a zero by ``exp(-x) = inf`` wherever
    ``x < -88`` and return NaN, where the reference's gradient is 0."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * s * (1 - s)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu(x)`` = ``x * logistic(x)``, op for op (see
    :class:`_Logistic`)."""
    return x * _Logistic.apply(x)


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        h = _silu(_mm(x, p["w_gate"])) * _mm(x, p["w_in"])
    elif cfg.mlp_act == "geglu":
        h = _gelu(_mm(x, p["w_gate"])) * _mm(x, p["w_in"])
    else:
        h = _gelu(_mm(x, p["w_in"]))
    h = shard(h, "batch", "seq", "ffn")
    return shard(_mm(h, p["w_out"]), "batch", "residual_seq", None)


# ---------------------------------------------------------------------------
# MoE (scatter dispatch into (E, C + 1, d) bins + batched expert GEMMs)
# ---------------------------------------------------------------------------


def moe_specs(cfg: ModelConfig) -> Dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    p = {
        "router": ParamSpec((d, E), ("fsdp", None), torch.float32),
        "w_gate": ParamSpec((E, d, ff), ("experts", "fsdp", "expert_ffn")),
        "w_in": ParamSpec((E, d, ff), ("experts", "fsdp", "expert_ffn")),
        "w_out": ParamSpec((E, ff, d), ("experts", "expert_ffn", "fsdp")),
    }
    if cfg.shared_experts:
        p["shared"] = mlp_specs(cfg, d, cfg.expert_d_ff * cfg.shared_experts)
    return p


class Routing(NamedTuple):
    """One ``apply_moe`` call's routing, for checks: each token's ``experts``
    (T, K) in rank order, whether each route ``kept`` a slot in its
    expert's bin (T, K), and the ``top`` K + 1 router probabilities (T, K + 1)
    in descending order (how near the K-th came to a tie).  A mesh
    dispatch records its own shard's tokens, with ``route`` the island
    (``"ep_a2a"`` or ``"shardmap"``; ``"dense"`` otherwise) and ``shard``
    the rank's coordinates, ``{axis: index}``.  ``probs`` (T, E) are the
    router's probabilities, so that two runs' routes can be told apart from
    the sums that moved them."""

    experts: torch.Tensor
    kept: torch.Tensor
    top: torch.Tensor
    route: str = "dense"
    shard: Optional[Dict[str, int]] = None
    probs: Optional[torch.Tensor] = None


_ROUTES: Optional[List[Routing]] = None


@contextlib.contextmanager
def recording_routes() -> Iterator[List[Routing]]:
    """Collect a :class:`Routing` per ``apply_moe`` call made inside the
    block, in call order (the tensors the call computed; no extra work)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _local_positions(flat_e: torch.Tensor) -> torch.Tensor:
    """Each route's rank within its expert in flat (token, rank) order: the
    reference's running count (``cumsum(one_hot) - 1``, and its
    ``_local_positions``), by a stable sort."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e)
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - first
    return torch.empty_like(rank).scatter_(0, order, rank)


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice MoE.  Returns (out, aux_loss).

    Under a mesh with a ``"model"`` axis, on the reference's conditions
    (``rules["experts"] == "model"``, ``E % tp == 0``, batch axes present
    and dividing B), it routes through an explicit island:
    ``_apply_moe_ep_a2a`` when the residual stream is seq-sharded over
    ``"model"`` (and ``tp`` divides S), else ``_apply_moe_shardmap``.
    Otherwise it is the dense dispatch (``_apply_moe_dense``), which under
    a mesh runs replicated on every rank.
    """
    mesh = current_mesh()
    if mesh is None:
        return _apply_moe_dense(p, x, cfg)
    sizes = mesh_sizes(mesh)
    if "model" in sizes:
        rules = current_rules()
        tp = sizes["model"]
        if rules.get("experts") == "model" and cfg.num_experts % tp == 0:
            batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
            bsz = int(np.prod([sizes[a] for a in batch_axes])) if batch_axes else 1
            if batch_axes and x.shape[0] % bsz == 0:
                # seq-sharded residual -> expert-parallel all-to-all island;
                # else the replicated-token island (decode)
                if rules.get("residual_seq") == "model" and x.shape[1] % tp == 0:
                    return _apply_moe_ep_a2a(p, x, cfg, mesh, batch_axes)
                return _apply_moe_shardmap(p, x, cfg, mesh, batch_axes)
    return shard_map(mesh, _apply_moe_dense, (None, None), (p, x, cfg), replicated=True)


def _moe_route(xt: torch.Tensor, router: torch.Tensor, K: int):
    """The float32 router's softmax, its top K by a stable descending sort
    (ties to the lower index, as ``lax.top_k``) and the renormalised gates:
    (probs, top (T, K + 1), experts (T, K), gates (T, K))."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)  # (T, E)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    experts = order[:, :K]
    gates = top[:, :K] / top[:, :K].sum(-1, keepdim=True)
    return probs, top[:, :K + 1], experts, gates


def _moe_balance(probs: torch.Tensor, flat_e: torch.Tensor):
    """Switch's (me, ce): the mean probability and the mean routes a token
    of each expert, over this call's T tokens."""
    T, E = probs.shape
    # routes an expert, counted without a host sync (CUDA's bincount has one)
    counts = probs.new_zeros(E).index_add_(0, flat_e, probs.new_ones(()).expand(flat_e.numel()))
    return _div(probs.sum(0), T), _div(counts, T)


def _expert_ffn(bins: torch.Tensor, wg, wi, wo, cfg: ModelConfig) -> torch.Tensor:
    """The experts' GEMMs, batched over the (E, C, d) bins."""
    dt = bins.dtype
    if cfg.mlp_act in ("swiglu", "geglu"):
        act = _silu if cfg.mlp_act == "swiglu" else _gelu
        h = act(torch.bmm(bins, wg.to(dt))) * torch.bmm(bins, wi.to(dt))
    else:
        h = _gelu(torch.bmm(bins, wi.to(dt)))
    return torch.bmm(h, wo.to(dt))


def _shared_ffn(xt: torch.Tensor, shared, cfg: ModelConfig) -> torch.Tensor:
    """The shared expert on (T, d) tokens: (gate, in, out) weights, whole
    or this rank's slice of the hidden dim."""
    sg, si, so = shared
    if cfg.mlp_act == "swiglu":
        hs = _silu(_mm(xt, sg)) * _mm(xt, si)
    elif cfg.mlp_act == "geglu":
        hs = _gelu(_mm(xt, sg)) * _mm(xt, si)
    else:
        hs = _gelu(_mm(xt, si))
    return _mm(hs, so)


def _shared_weights(p: Dict):
    sp = p["shared"]
    return (sp["w_gate"] if "w_gate" in sp else sp["w_in"], sp["w_in"], sp["w_out"])


def _record(route: str, mesh, experts, keep, top, probs):
    if _ROUTES is not None:
        coords = {a: coll.axis_index(mesh, a) for a in mesh.mesh_dim_names}
        _ROUTES.append(Routing(experts, keep, top.detach(), route, coords, probs.detach()))


def _batch_entry(batch_axes):
    return batch_axes if len(batch_axes) > 1 else batch_axes[0]


def _apply_moe_ep_a2a(p: Dict, x: torch.Tensor, cfg: ModelConfig, mesh,
                      batch_axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE with explicit all-to-all dispatch (GShard-style),
    the reference's island as a ``local_map`` body.

    Tokens are sharded over the batch axes and over ``"model"`` (seq); each
    shard routes its own tokens, scatters them into per-expert send bins of
    the per-shard capacity Cs = max(1, int(T_local K cf / E)) (an overflow
    row swallows the rest), exchanges them with the expert owners by an
    all-to-all over ``"model"``, runs its El = E / tp experts' GEMMs, and
    reverses the exchange.  ``me``/``ce`` are averaged over the batch axes
    and ``"model"``.  The shared expert is replicated: every rank serves
    its own tokens whole (a psum of partial products would mix different
    ranks' tokens).
    """
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    tp = mesh_sizes(mesh)["model"]
    El = E // tp
    red = tuple(batch_axes) + ("model",)

    def body(xl, router, wg, wi, wo, shared):
        Bl, Sl, _ = xl.shape
        T = Bl * Sl
        xt = xl.reshape(T, d)
        probs, top, experts, gates = _moe_route(xt, router, K)
        flat_e = experts.reshape(T * K)
        me, ce = _moe_balance(probs, flat_e)
        aux = (coll.pmean(me, mesh, red) * coll.pmean(ce, mesh, red)).sum() * E

        pos = _local_positions(flat_e)
        Cs = max(1, int(T * K * cfg.capacity_factor / E))  # per-source capacity
        ok = pos < Cs
        _record("ep_a2a", mesh, experts, ok.view(T, K), top, probs)
        dst = torch.where(ok, flat_e * Cs + pos, E * Cs)
        src = xt[:, None].expand(T, K, d).reshape(T * K, d)
        send = torch.zeros((E * Cs + 1, d), dtype=xt.dtype, device=xt.device)
        send = send.index_add(0, dst, src)[:E * Cs]          # (tp El Cs, d)
        recv = coll.all_to_all(send, mesh, "model")
        bins = recv.view(tp, El, Cs, d).transpose(0, 1).reshape(El, tp * Cs, d)
        outb = _expert_ffn(bins, wg, wi, wo, cfg)            # (El, tp Cs, d)
        back = outb.view(El, tp, Cs, d).transpose(0, 1).reshape(tp * El * Cs, d)
        ret = coll.all_to_all(back, mesh, "model")           # (E Cs, d)
        ret = torch.cat([ret, ret.new_zeros(1, d)])
        weighted = ret[dst].view(T, K, d) * gates[..., None].to(ret.dtype)
        out = weighted.sum(1)  # (T, d): complete locally
        if shared is not None:
            out = out + _shared_ffn(xt, shared, cfg)
        return out.view(Bl, Sl, d), aux

    bspec = (_batch_entry(batch_axes), "model", None)
    espec = ("model", None, None)
    shared = _shared_weights(p) if cfg.shared_experts else None
    sspec = ((None, None),) * 3 if shared is not None else None
    return shard_map(mesh, body, (bspec, None),
                   (x, p["router"], p["w_gate"], p["w_in"], p["w_out"], shared),
                   in_specs=(bspec, (None, None), espec, espec, espec, sspec))


def _apply_moe_shardmap(p: Dict, x: torch.Tensor, cfg: ModelConfig, mesh,
                        batch_axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit MoE, the reference's replicated-token island as a
    ``local_map`` body: tokens sharded over the batch axes and replicated
    over ``"model"``; each model rank routes the local tokens (capacity
    C = max(1, int(T_local K cf / E))) to its own slab of El = E / tp
    experts, and one psum over ``"model"`` (in the activation dtype: a
    bf16 payload) combines the expert and shared-FFN partials, the shared
    expert's hidden dim split over ``"model"``.  ``me``/``ce`` are averaged
    over the batch axes; the aux loss, alike on every model rank, counts
    once in the gradients."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    tp = mesh_sizes(mesh)["model"]
    El = E // tp

    def body(xl, router, wg, wi, wo, shared):
        m = coll.axis_index(mesh, "model")
        Bl = xl.shape[0]
        T = Bl * S
        xt = xl.reshape(T, d)
        probs, top, experts, gates = _moe_route(xt, router, K)
        flat_e = experts.reshape(T * K)
        me, ce = _moe_balance(probs, flat_e)
        me, ce = coll.pmean(me, mesh, batch_axes), coll.pmean(ce, mesh, batch_axes)
        aux = coll.grad_scale((me * ce).sum() * E, 1.0 / tp)

        pos = _local_positions(flat_e)
        C = max(1, int(T * K * cfg.capacity_factor / E))
        _record("shardmap", mesh, experts, (pos < C).view(T, K), top, probs)
        local_e = flat_e - m * El
        ok = (local_e >= 0) & (local_e < El) & (pos < C)
        dst = torch.where(ok, local_e.clamp(0, El - 1) * C + pos, El * C)
        src = xt[:, None].expand(T, K, d).reshape(T * K, d)
        bins = torch.zeros((El * C + 1, d), dtype=xt.dtype, device=xt.device)
        bins = bins.index_add(0, dst, src)[:El * C].view(El, C, d)
        out_bins = _expert_ffn(bins, wg, wi, wo, cfg).reshape(El * C, d)
        out_bins = torch.cat([out_bins, out_bins.new_zeros(1, d)])  # masked rows hit 0
        weighted = out_bins[dst].view(T, K, d) * gates[..., None].to(out_bins.dtype)
        part = weighted.sum(1)  # (T, d)
        if shared is not None:
            part = part + _shared_ffn(xt, shared, cfg)
        out = coll.psum(part.to(xl.dtype), mesh, "model")  # bf16 payload
        return out.view(Bl, S, d), aux

    bspec = (_batch_entry(batch_axes), None, None)
    espec = ("model", None, None)
    shared = _shared_weights(p) if cfg.shared_experts else None
    sspec = ((None, "model"), (None, "model"), ("model", None)) if shared is not None else None
    return shard_map(mesh, body, (bspec, None),
                   (x, p["router"], p["w_gate"], p["w_in"], p["w_out"], shared),
                   in_specs=(bspec, (None, None), espec, espec, espec, sspec))


def _apply_moe_dense(p: Dict, x: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense dispatch (``_apply_moe_dense``) op for op.

    The float32 router's softmax picks K experts a token, ties to the lower
    index as ``lax.top_k`` breaks them (a stable descending sort; ``topk``
    breaks them otherwise), and the K gates are renormalised.  Each expert
    takes C = max(1, int(T K capacity_factor / E)) routes in flat (token,
    rank) order; the rest are dropped into an overflow row.  Every expert's
    (C + 1, d) bin goes through its GEMMs, batched over E, and each kept
    route's output comes back weighted by its gate (cast to the activation
    dtype) and summed over K.  The aux loss is Switch's: E times the sum
    over experts of the mean probability and the mean routes a token.
    """
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    T = B * S
    xt = x.reshape(T, d)
    probs, top, experts, gates = _moe_route(xt, p["router"], K)
    flat_e = experts.reshape(T * K)
    me, ce = _moe_balance(probs, flat_e)  # load-balancing aux loss (Switch-style)
    aux = (me * ce).sum() * E

    C = max(1, int(T * K * cfg.capacity_factor / E))
    pos = _local_positions(flat_e)
    keep = pos < C
    if _ROUTES is not None:
        # recorded before the experts run: a recompute under non-reentrant
        # checkpointing stops once the backward has what it saved
        _ROUTES.append(Routing(experts, keep.view(T, K), top.detach(), probs=probs.detach()))
    # flat bin rows: a kept route's own slot, a dropped one the expert's
    # overflow row C (summed there and thrown away)
    dst = flat_e * (C + 1) + torch.where(keep, pos, C)
    src = xt[:, None].expand(T, K, d).reshape(T * K, d)
    bins = torch.zeros((E * (C + 1), d), dtype=xt.dtype, device=x.device)
    bins = bins.index_add_(0, dst, src).view(E, C + 1, d)
    bins = shard(bins, "experts", None, None)
    out_bins = _expert_ffn(bins, p.get("w_gate"), p["w_in"], p["w_out"], cfg).view(E * (C + 1), d)
    gathered = torch.where(keep[:, None], out_bins[dst], 0.0)
    weighted = gathered.view(T, K, d) * gates[..., None].to(out_bins.dtype)
    out = weighted.sum(1).view(B, S, d)
    if cfg.shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg)
    return shard(out, "batch", "seq", None), aux


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def ssd_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    N = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    conv_dim = di + 2 * N
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * N + H), ("fsdp", "ffn")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), ("conv", None)),
        "A_log": ParamSpec((H,), (None,), torch.float32, "zeros"),
        "D": ParamSpec((H,), (None,), torch.float32, "ones"),
        "dt_bias": ParamSpec((H,), (None,), torch.float32, "zeros"),
        "out_norm": {"scale": ParamSpec((di,), (None,), torch.float32, "ones")},
        "out_proj": ParamSpec((di, d), ("ffn", "fsdp")),
    }


def _ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, chunk: int,
              state0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space dual scan, the reference's ``_ssd_scan`` op for
    op.  x: (B, L, H, P); dt: (B, L, H) float32; A: (H,) (negative decay
    rates); Bm, Cm: (B, L, N).  Returns (y: (B, L, H, P), final state (B, H,
    N, P) float32).

    The reference scans the chunks with ``lax.scan``.  Only the carried
    state depends on the chunks before, so every chunk's own terms (the
    intra-chunk output, its state increment, its decays) are computed for
    all chunks at once, a loop over the chunks carries the state (a
    multiply and an add a chunk), and the carried states' outputs are one
    product over all chunks: each element is the reference's arithmetic,
    in as few launches as the recurrence allows.  The intra-chunk weights,
    the carried state and the increments' tails are cast to x's dtype where
    the reference casts them; the state stays float32.
    """
    Bsz, L, H, Pd = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"chunk {chunk} does not divide the length {L}")
    xr = x.reshape(Bsz, nc, chunk, H, Pd)
    dtr = dt.reshape(Bsz, nc, chunk, H)
    Br = Bm.reshape(Bsz, nc, chunk, N)
    Cr = Cm.reshape(Bsz, nc, chunk, N)
    cum = torch.cumsum(dtr * A, dim=2)  # within-chunk cumulative log decay (negative)
    # intra-chunk: y[i] = sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j,
    # masked in log space before the exp (no inf, no NaN gradient)
    Lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, i, j, H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[:, :, None], Lmat, NEG_INF))
    cb = _einsum("bzin,bzjn->bzij", Cr, Br)
    w = cb[..., None] * decay * dtr[:, :, None, :, :]
    y_intra = _einsum("bzijh,bzjhp->bzihp", w.to(x.dtype), xr)
    # each chunk's increment to the state: sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtr  # (B, nc, c, H)
    dBx = _einsum("bzjnh,bzjhp->bzhnp", Br[..., None] * tail.to(x.dtype)[:, :, :, None, :], xr)
    grow = torch.exp(cum[:, :, -1])  # (B, nc, H): the chunk's whole decay
    # the carried state, chunk by chunk: S' = S exp(sum dA) + dBx
    state = (torch.zeros((Bsz, H, N, Pd), dtype=torch.float32, device=x.device)
             if state0 is None else state0)
    carried = []  # the state each chunk starts from
    for c in range(nc):
        carried.append(state)
        state = state * grow[:, c, :, None, None].to(state.dtype) + dBx[:, c]
    # inter-chunk: y_i += C_i . state * exp(cum_i)
    y_inter = _einsum("bzin,bzhnp->bzihp", Cr, torch.stack(carried, 1).to(Cr.dtype))
    y = y_intra + y_inter * torch.exp(cum)[..., None].to(x.dtype)
    return y.reshape(Bsz, L, H, Pd), state


def _scan_chunk(cfg: ModelConfig, L: int) -> int:
    """``min(ssm_chunk, L)`` halved until it divides ``L``."""
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:
        chunk //= 2
    return max(chunk, 1)


def apply_ssd(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block, the reference's ``apply_ssd``: in projection, causal
    depthwise conv (with its ``K - 1`` rows of history), SiLU, the SSD, the
    skip ``D``, the gated RMS norm (eps 1e-6) and the out projection.

    ``cache = {"conv": (B, K-1, conv_dim), "state": (B, H, N, P) float32}``.
    Without one the chunked scan runs from a zero state; with one and
    ``S > 1`` it continues from ``cache["state"]``; at ``S == 1`` it is the
    one-step float32 recurrence.  With a cache the returned one holds new
    tensors (the cache is not written): ``conv`` is the last ``K - 1`` rows
    of the history in its promoted dtype (a bf16 history meeting float32
    activations is float32 from then on, as ``concatenate`` promotes it).
    """
    B, S, d = x.shape
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    H = di // cfg.ssm_head_dim
    Pd = cfg.ssm_head_dim
    proj = _mm(x, p["in_proj"])  # (B, S, 2 di + 2 N + H)
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,) negative

    Kc = cfg.ssm_conv
    w = p["conv_w"].to(x.dtype)
    if cache is None:
        hist = F.pad(xbc, (0, 0, Kc - 1, 0))
    else:
        hdt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
        hist = torch.cat([cache["conv"].to(hdt), xbc.to(hdt)], dim=1)  # (B, K-1+S, cd)
    conv = sum(hist[:, i:i + S] * w[i] for i in range(Kc))
    conv = _silu(conv)
    xs, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    xh = shard(xs.reshape(B, S, H, Pd), "batch", "seq", "ssm_heads", None)

    new_cache = None
    if cache is None or S > 1:
        # a prefill, from a zero state or continuing from the cached one
        y, state = _ssd_scan(xh, dt, A, Bm, Cm, _scan_chunk(cfg, S),
                             None if cache is None else cache["state"])
    else:
        # single-step recurrence (S == 1 decode)
        dA1 = torch.exp(dt[:, 0] * A)  # (B, H)
        dBx = (dt[:, 0, :, None] * Bm[:, 0, None, :].float())[..., None] \
            * xh[:, 0, :, None, :].float()  # (B, H, N, P)
        state = cache["state"] * dA1[:, :, None, None] + dBx
        y = _ein("bn,bhnp->bhp", Cm[:, 0].float(), state)[:, None].to(x.dtype)
    if cache is not None:
        new_cache = {"conv": hist[:, -(Kc - 1):], "state": state}
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, di)
    # gated RMS norm then out projection
    yf = y.float() * _silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * p["out_norm"]["scale"]
    out = _mm(yf.to(x.dtype), p["out_proj"])
    return shard(out, "batch", "seq", None), new_cache
