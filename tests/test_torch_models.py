"""repro_torch's LM substrate (configs, ParamSpec/materialize, the dense
decoder's layers, transformer and registry, the weight converter) held
against repro's (JAX on the CPU).

Both packages get the same numpy inputs and the reference's own weights:
``repro.runtime.sharding.materialize(specs, PRNGKey(s))`` -> numpy ->
``params_from_numpy``.  Tolerances are relative L2 errors, ||port - ref|| /
||ref||, per output:

* float32, end to end: ``F32`` = 1e-5.  A decode step (float32 cache) gets
  ``F32_STEP`` = 5e-5: at gemma2-2b's 16th step the reference's own logits
  are 2.5e-5 from a float64 evaluation of the same step, the port's 1.4e-6.
  The smoke models draw their stacked weights with std 1/sqrt(U) = 1 (the
  reference's std rule), so activations grow by ~10x a matmul and one-ulp
  differences (summation order, libm) grow with them.
* bf16 layers: ``BF16`` = 2e-3.  The port rounds where JAX rounds (GELU and
  SiLU op for op), so layer outputs differ only where a summation order
  flips a bf16 rounding (< 0.1% of elements).
* bf16 models: ``BF16_MODEL`` = 5e-2.  Those rare flips (2^-8 each) grow
  through the layers as above; the reference's own bf16 logits are 2-19%
  from its float32 logits on the same inputs.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.models.layers as RL
import repro.models.transformer as RT
from repro.models import build_model as ref_build
from repro.models.registry import cross_entropy as ref_ce
from repro.runtime import sharding as RS

import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.models import build_model, cross_entropy
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.runtime import sharding as TS

SRC = Path(__file__).resolve().parents[1] / "src"
F32, F32_STEP, BF16, BF16_MODEL = 1e-5, 5e-5, 2e-3, 5e-2
DTYPES = ["float32", "bfloat16"]
DENSE = ["gemma2-2b", "gemma3-12b", "starcoder2-3b", "deepseek-67b"]
SEQ = 80  # longer than the smoke window of 64, so local layers mask
STEPS = 16  # greedy_generate's prompt 8 + gen 8


def rel(port, ref) -> float:
    a = port.detach().double().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    b = np.asarray(ref).astype(np.float64)
    return float(np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b))


def _t(x):
    return params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]


def _cfgs(arch, dtype):
    return (dataclasses.replace(RC.ARCHS[arch].smoke(), dtype=dtype),
            dataclasses.replace(TC.ARCHS[arch].smoke(), dtype=dtype))


_MODELS = {}


def model(arch, dtype="float32", seed=0):
    """(ref cfg, port cfg, ref api, port api, numpy params, port params)."""
    key = (arch, dtype, seed)
    if key not in _MODELS:
        rcfg, tcfg = _cfgs(arch, dtype)
        rapi = ref_build(rcfg)
        # jitted, as the reference's greedy_generate runs them
        rapi = dataclasses.replace(rapi, prefill_fn=jax.jit(rapi.prefill_fn),
                                   decode_fn=jax.jit(rapi.decode_fn))
        pn = jax.tree.map(np.asarray, RS.materialize(rapi.param_specs, jax.random.PRNGKey(seed)))
        _MODELS[key] = (rcfg, tcfg, rapi, build_model(tcfg), pn, params_from_numpy(pn, "cpu"))
    return _MODELS[key]


def _tokens(n, seq, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, seq)).astype(np.int32)


def _act(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))


def _tol(dtype):
    return F32 if dtype == "float32" else BF16


# ---------------------------------------------------------------------------
# configs, specs, materialize, convert
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    assert list(TC.ARCHS) == list(RC.ARCHS)
    assert TC.LONG_CONTEXT_ARCHS == RC.LONG_CONTEXT_ARCHS
    assert TC.cells() == RC.cells() and TC.cells(True) == RC.cells(True)
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    assert dataclasses.astuple(TC.smoke_shape("decode")) == dataclasses.astuple(RC.smoke_shape("decode"))
    for name in RC.ARCHS:
        for r, t in ((RC.get_arch(name), TC.get_arch(name)),
                     (RC.get_arch(name).smoke(), TC.get_arch(name).smoke())):
            assert dataclasses.asdict(t) == dataclasses.asdict(r), name
            assert t.hd == r.hd
            assert t.adtype == (torch.bfloat16 if r.adtype == jnp.bfloat16 else torch.float32)
    with pytest.raises(KeyError):
        TC.get_arch("nope")


@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_match_reference_at_full_width(arch):
    r = ref_build(RC.ARCHS[arch]).param_specs
    t = build_model(TC.ARCHS[arch]).param_specs
    rl, tl = list(RS._leaf_paths(r)), list(TS._leaf_paths(t))
    assert [p for p, _ in tl] == [p for p, _ in rl]
    for (_, a), (_, b) in zip(tl, rl):
        assert (a.shape, a.logical, a.init, a.scale) == (b.shape, b.logical, b.init, b.scale)
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name
    assert TS.param_count(t) == RS.param_count(r)
    assert TS.param_bytes(t) == RS.param_bytes(r)
    if arch == "gemma2-2b":  # 2.614 B parameters, 5.229 GB in bf16
        assert round(TS.param_count(t) / 1e9, 3) == 2.614
        assert round(TS.param_bytes(t) / 1e9, 3) == 5.229


_MATERIALIZE_CHECK = """
import dataclasses, numpy as np, torch
import repro_torch.configs as TC
from repro_torch.models import build_model
from repro_torch.runtime import sharding as TS
# gemma2-2b, and the encoder-decoder's and the VLM's own leaves (encoder/...,
# frontend_proj, xattn, ln_xattn)
for arch in ("gemma2-2b", "seamless-m4t-medium", "internvl2-2b"):
    cfg = dataclasses.replace(TC.ARCHS[arch].smoke(), d_model=512, d_ff=1024,
                              frontend_dim=256 if TC.ARCHS[arch].frontend_dim else 0)
    specs = build_model(cfg).param_specs
    p = TS.materialize(specs, 7, device="cpu")
    again = dict(TS._leaf_paths(TS.materialize(specs, 7, device="cpu")))
    other = dict(TS._leaf_paths(TS.materialize(specs, 8, device="cpu")))
    for (path, ps), (_, x) in zip(TS._leaf_paths(specs), TS._leaf_paths(p)):
        assert tuple(x.shape) == ps.shape and x.dtype == ps.dtype, path
        assert torch.equal(x, again[path]), path
        if ps.init in ("ones", "zeros"):
            assert torch.all(x == (1 if ps.init == "ones" else 0)), path
            continue
        assert not torch.equal(x, other[path]), path
        # std = scale / sqrt(shape[0]): for a stacked leaf that is 1/sqrt(U), not d
        want = 0.02 if ps.init == "embed" else 1 / np.sqrt(ps.shape[0])
        assert abs(x.float().std().item() / want - 1) < 0.01, path
        assert abs(x.float().mean().item()) < 0.01 * want, path
    # every leaf draws its own stream
    wq, wk = p["blocks"]["l0"]["attn"]["wq"], p["blocks"]["l0"]["attn"]["wk"]
    assert not torch.equal(wq[..., : wk.shape[-1]], wk)
    if cfg.family == "encdec":
        assert not torch.equal(p["blocks"]["l0"]["xattn"]["wq"], p["blocks"]["l0"]["attn"]["wq"])
        assert not torch.equal(p["encoder"]["frontend_proj"][:, :128],
                               p["encoder"]["blocks"]["l0"]["attn"]["wq"][0, :256])
print("ok")
"""


def test_materialize_keeps_the_reference_distribution():
    # in a process of its own: after a run of large CPU randn calls, the next
    # parallel exp/tanh of this PyTorch CPU build is off by ~1e-4 on one
    # thread's chunk in some processes, which would leak into later tests
    res = subprocess.run([sys.executable, "-c", _MATERIALIZE_CHECK], capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_spec_and_shard_helpers():
    with pytest.raises(ValueError):
        TS.ParamSpec((2, 3), (None,))
    x = torch.ones(4, 4)
    assert TS.shard(x, "batch", None) is x
    ps = TS.ParamSpec((3,), (None,))
    assert ps.dtype == torch.bfloat16 and ps.init == "normal" and ps.scale == 1.0


def test_convert_is_bit_exact():
    _, _, _, _, pn, tp = model("gemma2-2b", "bfloat16")
    for (path, a), (_, b) in zip(RS._leaf_paths(pn), TS._leaf_paths(tp)):
        assert b.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32), path
        bits = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        got = b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 else b.numpy()
        assert np.array_equal(got, bits), path
    c = cache_from_numpy({"l0": {"k": np.zeros((1, 2), np.float32)}, "len": np.int32(5)}, "cpu")
    assert c["len"] == 5 and isinstance(c["len"], int)
    with pytest.raises(TypeError):
        params_from_numpy({"x": np.array(["a"])}, "cpu")


def test_batch_and_cache_declarations_match_reference():
    rcfg, tcfg = _cfgs("gemma2-2b", "bfloat16")
    rapi, tapi = ref_build(rcfg), build_model(tcfg)
    for shape in [RC.smoke_shape(k) for k in ("train", "prefill", "decode")]:
        tshape = TC.ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        for r, t in ((rapi.batch_specs(shape), tapi.batch_specs(tshape)),
                     (rapi.cache_decl(shape), tapi.cache_decl(tshape))):
            rl, tl = list(RS._leaf_paths(r)), list(TS._leaf_paths(t))
            assert [(p, s.shape, s.logical, s.init) for p, s in tl] == \
                [(p, s.shape, s.logical, s.init) for p, s in rl]
            assert [str(s.dtype).split(".")[-1] for _, s in tl] == \
                [jnp.dtype(s.dtype).name for _, s in rl]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm, dtype):
    rng = np.random.default_rng(1)
    rcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in _cfgs("gemma2-2b", dtype))
    x = _act(rng, (2, 9, 128), dtype, 3.0)
    p = {"scale": (1 + 0.1 * rng.standard_normal(128)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(128)).astype(np.float32)}
    out = TL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    ref = RL.apply_norm(p, jnp.asarray(x), rcfg)
    assert out.dtype == tcfg.adtype
    assert rel(out, ref) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_softcap_and_rope(dtype):
    rng = np.random.default_rng(2)
    x = _act(rng, (2, SEQ, 4, 32), dtype, 40.0)
    assert rel(TL.softcap(_t(x), 50.0), RL.softcap(jnp.asarray(x), 50.0)) <= _tol(dtype)
    assert torch.equal(TL.softcap(_t(x), 0.0), _t(x))
    pos = np.broadcast_to(np.arange(3, 3 + SEQ, dtype=np.int32), (2, SEQ)).copy()
    for theta in (10_000.0, 1_000_000.0):
        out = TL.rope(_t(x), torch.from_numpy(pos), theta)
        assert out.dtype == _t(x).dtype
        assert rel(out, RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layer", ["local", "global"])
@pytest.mark.parametrize("branch", ["decode", "chunked"])
def test_multihead_attention(branch, layer, dtype):
    """GQA (4 heads over 2 KV heads), softcapped, at 80 keys against the
    smoke window of 64; the chunked branch runs 3 chunks of 32 (the last
    padded) and the decode branch 4 queries at the end."""
    rng = np.random.default_rng(3)
    B, H, KV, hd = 2, 4, 2, 32
    q = _act(rng, (B, SEQ, H, hd), dtype, 3.0)
    k = _act(rng, (B, SEQ, KV, hd), dtype, 3.0)
    v = _act(rng, (B, SEQ, KV, hd), dtype)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (B, SEQ)).copy()
    qs = slice(SEQ - 4, SEQ) if branch == "decode" else slice(None)
    kw = dict(layer_type=layer, window=64, attn_softcap=50.0, kv_chunk=32)
    out = TL.multihead_attention(_t(q[:, qs]), _t(k), _t(v), torch.from_numpy(pos[:, qs]),
                                 torch.from_numpy(pos), **kw)
    ref = RL.multihead_attention(*map(jnp.asarray, (q[:, qs], k, v, pos[:, qs], pos)), **kw)
    assert out.shape == ref.shape and out.dtype == _t(v).dtype
    assert rel(out, ref) <= _tol(dtype)
    if layer == "local":  # the window bites: the global result differs
        glob = TL.multihead_attention(_t(q[:, qs]), _t(k), _t(v), torch.from_numpy(pos[:, qs]),
                                      torch.from_numpy(pos), **dict(kw, layer_type="global"))
        assert rel(glob, ref) > 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 12], ids=["decode", "chunked"])
def test_attention_block_with_a_cache(S, dtype):
    """gemma2-2b's local layer (qk as the reference's weights give them)
    appending S tokens at position 70 to a cache of 96 slots that already
    holds 70 (so the window of 64 masks): output and the whole cache."""
    rcfg, tcfg, _, _, pn, tp = model("gemma2-2b", dtype)
    rng = np.random.default_rng(4)
    KV, hd, T, start = tcfg.num_kv_heads, tcfg.hd, 96, 70
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ck = np.zeros((2, T, KV, hd), np.float32)
    cv = np.zeros((2, T, KV, hd), np.float32)
    ck[:, :start] = rng.standard_normal((2, start, KV, hd)) * 10
    cv[:, :start] = rng.standard_normal((2, start, KV, hd)) * 10
    ck, cv = np.asarray(jnp.asarray(ck, cdt)), np.asarray(jnp.asarray(cv, cdt))
    x = _act(rng, (2, S, tcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (2, S)).copy()
    rp = jax.tree.map(lambda a: a[0], pn["blocks"]["l0"]["attn"])
    tpp = jax.tree.map(lambda a: a[0], tp["blocks"]["l0"]["attn"])
    ref, rc = RL.attention_block(rp, jnp.asarray(x), jnp.asarray(pos), rcfg, layer_type="local",
                                 cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                                        "len": jnp.int32(start)})
    tcache = cache_from_numpy({"k": ck, "v": cv, "len": np.int32(start)}, "cpu")
    out, nc = TL.attention_block(tpp, _t(x), torch.from_numpy(pos), tcfg, layer_type="local",
                                 cache=tcache)
    assert nc["len"] == start + S and int(rc["len"]) == start + S
    assert nc["k"] is tcache["k"]  # written in place
    for name in ("k", "v"):
        assert rel(nc[name], rc[name]) <= _tol(dtype)
    assert rel(out, ref) <= _tol(dtype)
    with pytest.raises(ValueError, match="cache"):
        TL.attention_block(tpp, _t(x), torch.from_numpy(pos + T - start), tcfg,
                           cache={"k": tcache["k"], "v": tcache["v"], "len": T})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(act, dtype):
    rng = np.random.default_rng(5)
    rcfg, tcfg = (dataclasses.replace(c, mlp_act=act) for c in _cfgs("gemma2-2b", dtype))
    specs = RL.mlp_specs(rcfg, 128, 256)
    p = jax.tree.map(np.asarray, RS.materialize(specs, jax.random.PRNGKey(5)))
    # weights at 1/sqrt(d) so the activations reach GELU's curved range
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a.astype(np.float32) / 8, a.dtype)), p)
    x = _act(rng, (2, 9, 128), dtype, 2.0)
    out = TL.apply_mlp(params_from_numpy(p, "cpu"), _t(x), tcfg)
    ref = RL.apply_mlp(p, jnp.asarray(x), rcfg)
    assert out.dtype == tcfg.adtype
    assert rel(out, ref) <= _tol(dtype)


# ---------------------------------------------------------------------------
# the decoder, the registry
# ---------------------------------------------------------------------------


def _model_tol(dtype):
    return F32 if dtype == "float32" else BF16_MODEL


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_forward_prefill_and_loss(dtype):
    rcfg, tcfg, rapi, tapi, pn, tp = model("gemma2-2b", dtype)
    toks = _tokens(2, SEQ)
    logits, cache, aux = TT.decoder_forward(tp, torch.from_numpy(toks), tcfg)
    rlog, _, raux = RT.decoder_forward(pn, jnp.asarray(toks), rcfg)
    assert cache is None and float(aux) == float(raux) == 0.0
    assert logits.dtype == torch.float32 and logits.shape == rlog.shape
    assert float(logits.abs().max()) <= tcfg.logit_softcap
    assert rel(logits, rlog) <= _model_tol(dtype)
    pre = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert rel(pre, rapi.prefill_fn(pn, {"tokens": jnp.asarray(toks)})) <= _model_tol(dtype)
    labels = _tokens(2, SEQ, seed=9)
    labels[0, :5] = -1  # ignored
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    total, m = tapi.loss_fn(tp, batch)
    rtotal, rm = rapi.loss_fn(pn, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    assert int(m["ntok"]) == int(rm["ntok"]) == 2 * SEQ - 5
    assert rel(total, rtotal) <= _model_tol(dtype) and rel(m["ce"], rm["ce"]) <= _model_tol(dtype)
    # DecoderLM holds the tree under the reference's paths
    lm = TT.DecoderLM(tcfg, tp)
    assert sorted(lm.state_dict()) == sorted(".".join(p) for p, _ in RS._leaf_paths(pn))
    assert torch.equal(lm(torch.from_numpy(toks))[0], logits)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((2, 7, 33)) * 4).astype(np.float32)
    labels = rng.integers(-1, 33, (2, 7)).astype(np.int32)
    loss, n = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    rloss, rn = ref_ce(jnp.asarray(logits), jnp.asarray(labels))
    assert float(n) == float(rn) and rel(loss, rloss) <= F32


def _decode_steps(arch, dtype, cache_dtype, steps):
    """Both packages decode the same ``steps`` tokens one at a time, each
    from a zero cache of ``cache_dtype`` (None: ``cache_decl``'s); returns
    the worst step's relative error and both caches."""
    rcfg, tcfg, rapi, tapi, pn, tp = model(arch, dtype)
    decl = rapi.cache_decl(RC.ShapeConfig("s", steps + 8, 2, "decode"))
    rc = jax.tree.map(
        lambda ps: jnp.zeros(ps.shape, cache_dtype if cache_dtype and ps.shape else ps.dtype),
        decl, is_leaf=lambda x: isinstance(x, RS.ParamSpec))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    toks = _tokens(2, steps, seed=1)
    worst = 0.0
    for i in range(steps):
        rlog, rc = rapi.decode_fn(pn, rc, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        tlog, tc = tapi.decode_fn(tp, tc, {"tokens": torch.from_numpy(toks[:, i:i + 1])})
        assert tlog.shape == rlog.shape == (2, 1, tcfg.vocab_size)
        worst = max(worst, rel(tlog, rlog))
    assert tc["len"] == int(rc["len"]) == steps
    return worst, rc, tc


@pytest.mark.parametrize("case", ["float32", "float32-bf16-cache", "bfloat16"])
def test_decode_steps(case):
    """16 decode steps of gemma2-2b: float32 with a float32 cache, float32
    with the declared (bf16) cache, whose k and v and whose probabilities
    the reference rounds to bf16, and bf16."""
    dtype = case.split("-")[0]
    cache_dtype = jnp.float32 if case == "float32" else None
    worst, rc, tc = _decode_steps("gemma2-2b", dtype, cache_dtype, STEPS)
    assert worst <= (F32_STEP if case == "float32" else BF16_MODEL), worst
    assert tc["l0"]["k"].dtype == (torch.float32 if case == "float32" else torch.bfloat16)
    assert rel(tc["l1"]["v"], rc["l1"]["v"]) <= (F32_STEP if case == "float32" else BF16_MODEL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE[1:])
@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_other_dense_archs(what, arch, dtype):
    rcfg, tcfg, rapi, tapi, pn, tp = model(arch, dtype)
    if what == "prefill":
        toks = _tokens(2, SEQ)
        out = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
        err = rel(out, rapi.prefill_fn(pn, {"tokens": jnp.asarray(toks)}))
        assert err <= _model_tol(dtype), err
    else:
        worst, _, _ = _decode_steps(arch, dtype, jnp.float32 if dtype == "float32" else None, 8)
        assert worst <= (F32_STEP if dtype == "float32" else BF16_MODEL), worst


def test_build_model_builds_every_arch():
    """``build_model`` builds every arch of the registry at the smoke size,
    its parameters, caches and batches declared as the reference declares
    them."""
    for arch in TC.ARCHS:
        rapi, tapi = ref_build(RC.ARCHS[arch].smoke()), build_model(TC.ARCHS[arch].smoke())
        assert tapi.cfg.family == RC.ARCHS[arch].family
        assert TS.param_count(tapi.param_specs) == RS.param_count(rapi.param_specs), arch
        for kind in ("train", "prefill", "decode"):
            r, t = RC.smoke_shape(kind), TC.smoke_shape(kind)
            assert [(p, s.shape) for p, s in TS._leaf_paths(tapi.cache_decl(t))] == \
                [(p, s.shape) for p, s in RS._leaf_paths(rapi.cache_decl(r))], (arch, kind)
            assert [(p, s.shape) for p, s in TS._leaf_paths(tapi.batch_specs(t))] == \
                [(p, s.shape) for p, s in RS._leaf_paths(rapi.batch_specs(r))], (arch, kind)
