"""repro_torch's encoder-decoder and VLM families (``models.layers``'
cross-attention, ``models.transformer``'s encoder, cross cache and patch
prefix, their registry entries, caches and the serve and train paths) held
against repro's (JAX on the CPU).

Both packages get the same numpy inputs.  Weights are drawn with numpy from
a seed (``draw``): every matrix at std 1/sqrt(fan-in), the embedding at std
1, the LayerNorms' scales in [0.5, 1.5) and their biases at std 0.1, so
that a bias or a scale that is dropped shows.  (The reference's std rule,
1/sqrt(U) = 1/sqrt(2) for the smoke models' stacked matrices, makes the
activations grow ~10x a matmul; at fan-in std the bf16 cases measure the
port's rounding, not that growth.)  The generation test hands the same
draw to ``repro.launch.serve.greedy_generate`` in place of its own.

Tolerances are tests/test_torch_models.py's relative L2 errors: ``F32`` =
1e-5, ``F32_STEP`` = 5e-5 for a cached call, ``BF16`` = 2e-3 for one bf16
layer, ``BF16_MODEL`` = 5e-2 for a bf16 stack of layers, and ``F32_GRAD``
= 2e-3 for a gradient leaf (tests/test_torch_train.py's: bf16 matrices'
gradients are float32 gradients rounded to bf16).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.launch.serve as RSERVE
import repro.models.layers as RL
import repro.models.transformer as RT
from repro.models import build_model as ref_build
from repro.models.registry import cross_entropy as ref_ce
from repro.runtime import sharding as RS

import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.launch.serve import greedy_generate, main
from repro_torch.launch.steps import value_and_grad
from repro_torch.launch.train import train
from repro_torch.models import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.runtime import sharding as TS

F32, F32_STEP, BF16, BF16_MODEL, F32_GRAD = 1e-5, 5e-5, 2e-3, 5e-2, 2e-3
ENCDEC, VLM = "seamless-m4t-medium", "internvl2-2b"
ARCHS = [ENCDEC, VLM]
DTYPES = ["float32", "bfloat16"]
SEQ = 40  # text tokens of a prefill and a loss (the VLM's 8 patches ahead)
SRC = 24  # source frames of the encoder-decoder
PROMPT, STEPS = 12, 6  # the cached test: a prompt prefilled in one call, then single steps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    a = port.detach().double().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    b = np.asarray(ref).astype(np.float64)
    return float(np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b))


def _t(x):
    return params_from_numpy({"x": np.asarray(x)}, "cpu")["x"]


def _tol(dtype):
    return F32 if dtype == "float32" else BF16_MODEL


def _step_tol(dtype):
    return F32_STEP if dtype == "float32" else BF16_MODEL


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def draw(specs, seed=0):
    """A numpy tree for ``specs`` (the reference's declaration): matrices at
    std 1/sqrt(fan-in), the embedding at std 1, norm scales in [0.5, 1.5),
    norm biases at std 0.1."""
    rng = np.random.default_rng(seed)

    def one(path, ps):
        name, shape = path[-1], ps.shape
        if name == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            a = 0.1 * rng.standard_normal(shape)
        elif name == "embed":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return np.asarray(jnp.asarray(a, ps.dtype))

    return RS._map_leaves(one, specs)


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(RC.ARCHS[arch].smoke(), dtype=dtype, **kw),
            dataclasses.replace(TC.ARCHS[arch].smoke(), dtype=dtype, **kw))


def _tokens(n, seq, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, seq)).astype(np.int32)


def _embeds(n, seq, dim, seed=0):
    """Stub frame or patch embeddings, float32 as ``with_frontend`` makes them."""
    return np.random.default_rng(seed).standard_normal((n, seq, dim)).astype(np.float32)


_MODELS = {}


def model(arch, dtype):
    """(ref cfg, port cfg, ref api, port api, numpy params, port params)."""
    key = (arch, dtype)
    if key not in _MODELS:
        rcfg, tcfg = _cfgs(arch, dtype)
        rapi = ref_build(rcfg)
        pn = draw(rapi.param_specs)
        _MODELS[key] = (rcfg, tcfg, rapi, build_model(tcfg), pn, params_from_numpy(pn, "cpu"))
    return _MODELS[key]


def _batch(arch, seed=5):
    """A train batch at the smoke widths: SEQ text tokens and labels (a few
    masked), and the arch's frontend input (SRC frames, or 8 patches)."""
    cfg = TC.ARCHS[arch].smoke()
    labels = _tokens(2, SEQ, seed + 4)
    labels[1, :3] = -1
    b = {"tokens": _tokens(2, SEQ, seed), "labels": labels}
    if arch == ENCDEC:
        b["frames"] = _embeds(2, SRC, cfg.frontend_dim, seed + 1)
    else:
        b["patches"] = _embeds(2, cfg.frontend_len, cfg.frontend_dim, seed + 1)
    return b


# ---------------------------------------------------------------------------
# the reference's programs, one compile each, shared across cases
# ---------------------------------------------------------------------------

_REF = {}


def ref_forward(arch, dtype):
    """The reference's logits, loss and ntok over ``_batch(arch)``, and for
    the encoder-decoder its encoder output and cross cache: one jitted
    program a model.  The reference's ``loss_fn`` is its forward and
    ``cross_entropy`` (over the text's logits), traced once here; its own
    call is held in the gradient test."""
    key = ("forward", arch, dtype)
    if key not in _REF:
        rcfg, _, _, _, pn, _ = model(arch, dtype)
        b = _batch(arch)

        def fwd(p, b):
            out = {}
            if arch == ENCDEC:
                enc = RT.encoder_forward(p, b["frames"], rcfg)
                out["enc_out"], out["xkv"] = enc, RT.build_xattn_cache(p, enc, rcfg)
                kw = {"enc_out": enc, "src_positions": jnp.broadcast_to(
                    jnp.arange(SRC, dtype=jnp.int32)[None], (2, SRC))}
            else:
                kw = {"patches": b["patches"]}
            out["logits"], _, aux = RT.decoder_forward(p, b["tokens"], rcfg, **kw)
            ce, ntok = ref_ce(out["logits"][:, rcfg.frontend_len:], b["labels"])
            out["loss"], out["metrics"] = ce, {"ce": ce, "aux": aux, "ntok": ntok}
            return out

        out = jax.jit(fwd)(pn, jax.tree.map(jnp.asarray, b))
        _REF[key] = (b, jax.tree.map(np.asarray, out))
    return _REF[key]


def _zero_cache(rapi, shape, dtype):
    """The declared cache as zeros; a float32 model's self-attention k and v
    in float32 (a float32 cached call stays float32)."""
    decl = rapi.cache_decl(shape)

    def one(path, ps):
        f32 = dtype == "float32" and path[0] != "xkv" and ps.shape
        return np.zeros(ps.shape, np.float32 if f32 else ps.dtype)

    return RS._map_leaves(one, decl)


def ref_cached(arch, dtype):
    """The reference's cached run: the encoder-decoder's encoder over SRC
    frames and its cross cache from ``build_xattn_cache``, or the VLM's
    patches; a PROMPT-token prefill into the cache in one
    ``decoder_forward`` call; STEPS single ``decode_fn`` steps, each fed the
    previous step's argmax.  Returns the inputs, every call's logits and
    the final cache."""
    key = ("cached", arch, dtype)
    if key not in _REF:
        rcfg, tcfg, rapi, _, pn, _ = model(arch, dtype)
        cache = _zero_cache(rapi, RC.ShapeConfig("c", 24 + tcfg.frontend_len, 2, "decode"), dtype)
        prompt = _tokens(2, PROMPT, seed=7)
        inputs = {"prompt": prompt}
        kw = {}
        b, ref = ref_forward(arch, dtype)  # the batch's frames or patches
        if arch == ENCDEC:
            inputs["frames"] = b["frames"]
            cache["xkv"] = ref["xkv"]
        else:
            inputs["patches"] = b["patches"]
            kw["patches"] = jnp.asarray(b["patches"])
        prefill = jax.jit(lambda p, t, c, **kw: RT.decoder_forward(
            p, t, rcfg, cache=c, cache_len=c["len"], **kw)[:2])
        logits, cache = prefill(pn, jnp.asarray(prompt), jax.tree.map(jnp.asarray, cache), **kw)
        calls, fed = [np.asarray(logits)], []
        decode = jax.jit(rapi.decode_fn)
        for _ in range(STEPS):
            nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
            fed.append(np.array(nxt))
            logits, cache = decode(pn, cache, {"tokens": nxt})
            calls.append(np.asarray(logits))
        inputs["fed"] = fed
        _REF[key] = (inputs, calls, jax.tree.map(np.asarray, cache))
    return _REF[key]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _same_decl(r, t):
    rl, tl = list(RS._leaf_paths(r)), list(TS._leaf_paths(t))
    assert [(p, s.shape, s.logical, s.init, s.scale) for p, s in tl] == \
        [(p, s.shape, s.logical, s.init, s.scale) for p, s in rl]
    assert [str(s.dtype).split(".")[-1] for _, s in tl] == [jnp.dtype(s.dtype).name for _, s in rl]


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference_at_full_width(arch):
    """Parameters, caches (with the cross cache ``xkv``) and batches for
    train, prefill and decode as the reference declares them, at the
    published widths and depths (nothing is drawn): seamless-m4t-medium's
    0.616 B parameters, 0.152 B of them the encoder; internvl2-2b's 1.702 B
    with its 1024 -> 2048 ``frontend_proj``."""
    rapi, tapi = ref_build(RC.ARCHS[arch]), build_model(TC.ARCHS[arch])
    _same_decl(rapi.param_specs, tapi.param_specs)
    assert TS.param_count(tapi.param_specs) == RS.param_count(rapi.param_specs)
    assert TS.param_bytes(tapi.param_specs) == RS.param_bytes(rapi.param_specs)
    for shape in [RC.smoke_shape(k) for k in ("train", "prefill", "decode")] + [
            RC.SHAPES["train_4k"], RC.SHAPES["decode_32k"]]:
        tshape = TC.ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        _same_decl(rapi.cache_decl(shape), tapi.cache_decl(tshape))
        _same_decl(rapi.batch_specs(shape), tapi.batch_specs(tshape))
    n = TS.param_count(tapi.param_specs)
    decl = tapi.cache_decl(TC.ShapeConfig("d", 4096, 2, "decode"))
    bs = tapi.batch_specs(TC.SHAPES["train_4k"])
    if arch == ENCDEC:
        assert round(n / 1e9, 3) == 0.616
        assert round(TS.param_count(tapi.param_specs["encoder"]) / 1e9, 3) == 0.152
        assert decl["xkv"]["l0"]["k"].shape == (12, 2, 1024, 16, 64)
        assert bs["frames"].shape == (256, 1024, 1024) and bs["tokens"].shape == (256, 4096)
        assert set(tapi.param_specs["blocks"]["l0"]) == {
            "ln_attn", "attn", "ln_xattn", "xattn", "ln_mlp", "mlp"}
    else:
        assert round(n / 1e9, 3) == 1.702 and "xkv" not in decl
        assert tapi.param_specs["frontend_proj"].shape == (1024, 2048)
        assert bs["patches"].shape == (256, 256, 1024) and bs["tokens"].shape == (256, 3840)


# ---------------------------------------------------------------------------
# cross-attention, the encoder and its cross cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qk_norm,branch,dtype", [
    (False, "direct", "float32"), (True, "direct", "bfloat16"),
    (False, "chunked", "bfloat16"), (True, "chunked", "float32")])
def test_attention_block_cross(qk_norm, branch, dtype):
    """``attention_block`` with ``xattn_kv`` against the reference's: q
    alone projected, without RoPE, normalized alone under ``qk_norm``; k, v
    and their positions as given; no cache.  ``Sq <= 8`` takes the direct
    split-K form (4 queries over 40 keys); 24 queries over 1100 keys the
    chunked one (two chunks of 1024, the second padded).  Each of qk_norm
    and the branch runs in both dtypes."""
    sq, sk = {"direct": (4, 40), "chunked": (24, 1100)}[branch]
    rcfg, tcfg = _cfgs(ENCDEC, dtype, qk_norm=qk_norm)
    p = draw(RL.attention_specs(rcfg), seed=3)
    rng = np.random.default_rng(3)
    adt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    KV, hd = rcfg.num_kv_heads, rcfg.hd
    x = np.asarray(jnp.asarray(rng.standard_normal((2, sq, rcfg.d_model)), adt))
    k = np.asarray(jnp.asarray(rng.standard_normal((2, sk, KV, hd)), adt))
    v = np.asarray(jnp.asarray(rng.standard_normal((2, sk, KV, hd)), adt))
    qpos = np.broadcast_to(np.arange(30, 30 + sq, dtype=np.int32), (2, sq))
    kpos = np.broadcast_to(np.arange(sk, dtype=np.int32), (2, sk))
    ref, rc = jax.jit(lambda p, x, k, v, qp, kp: RL.attention_block(
        p, x, qp, rcfg, causal=False, xattn_kv=(k, v, kp)))(p, x, k, v, qpos, kpos)
    tp = params_from_numpy(p, "cpu")
    out, nc = TL.attention_block(tp, _t(x), torch.from_numpy(qpos.copy()), tcfg, causal=False,
                                 xattn_kv=(_t(k), _t(v), torch.from_numpy(kpos.copy())))
    assert nc is None and rc is None
    assert out.dtype == tcfg.adtype and out.shape == ref.shape == (2, sq, rcfg.d_model)
    assert rel(out, ref) <= (F32 if dtype == "float32" else BF16)
    if qk_norm:  # q is normalized: a scale on knorm changes nothing
        tp["knorm"]["scale"].mul_(3.0)
        again, _ = TL.attention_block(tp, _t(x), torch.from_numpy(qpos.copy()), tcfg,
                                      causal=False, xattn_kv=(_t(k), _t(v),
                                                              torch.from_numpy(kpos.copy())))
        assert torch.equal(again, out)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_forward(dtype):
    """``encoder_forward`` over SRC stub frames: the projection, two
    bidirectional layers and the final LayerNorm."""
    _, tcfg, _, _, _, tp = model(ENCDEC, dtype)
    b, ref = ref_forward(ENCDEC, dtype)
    enc = TT.encoder_forward(tp, torch.from_numpy(b["frames"]), tcfg)
    assert enc.dtype == tcfg.adtype and enc.shape == ref["enc_out"].shape == (2, SRC, 128)
    assert rel(enc, ref["enc_out"]) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_build_xattn_cache(dtype):
    """``build_xattn_cache`` on the reference's encoder output: every
    unit's cross K and V, (U, B, Ssrc, KV, hd)."""
    _, tcfg, _, _, _, tp = model(ENCDEC, dtype)
    _, ref = ref_forward(ENCDEC, dtype)
    xkv = TT.build_xattn_cache(tp, _t(ref["enc_out"]), tcfg)
    flat, rflat = _flat(xkv), _flat(ref["xkv"])
    assert sorted(flat) == sorted(rflat) == ["/l0/k", "/l0/v"]
    for k, v in flat.items():
        assert v.shape == rflat[k].shape == (2, 2, SRC, 2, 32) and v.dtype == tcfg.adtype
        assert rel(v, rflat[k]) <= (F32 if dtype == "float32" else BF16), k


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_loss(arch, dtype):
    """The forward over SEQ text tokens (the encoder-decoder attending to
    SRC encoded frames; the VLM's 8 patches ahead of the text, so 48
    logits), ``prefill_fn`` and ``loss_fn`` (the VLM's loss drops the
    patches' logits): logits, loss, ce, aux and ntok."""
    _, tcfg, _, tapi, _, tp = model(arch, dtype)
    b, ref = ref_forward(arch, dtype)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if arch == ENCDEC:
        enc = TT.encoder_forward(tp, tb["frames"], tcfg)
        kw = {"enc_out": enc, "src_positions": torch.arange(SRC, dtype=torch.int32)[None]
              .expand(2, SRC)}
    else:
        kw = {"patches": tb["patches"]}
    logits, cache, aux = TT.decoder_forward(tp, tb["tokens"], tcfg, **kw)
    S = SEQ + tcfg.frontend_len
    assert cache is None and float(aux) == 0.0 and logits.shape == ref["logits"].shape == (2, S, 512)
    assert logits.dtype == torch.float32 and rel(logits, ref["logits"]) <= _tol(dtype)
    pre = tapi.prefill_fn(tp, {k: v for k, v in tb.items() if k != "labels"})
    assert torch.equal(pre, logits[:, -1:])
    loss, m = tapi.loss_fn(tp, tb)
    assert sorted(m) == sorted(ref["metrics"]) == ["aux", "ce", "ntok"]
    assert int(m["ntok"]) == int(ref["metrics"]["ntok"]) == 2 * SEQ - 3
    assert rel(loss, ref["loss"]) <= _tol(dtype) and float(m["aux"]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_after_prefill(arch, dtype):
    """The serving path's real prefill, then cached steps: the
    encoder-decoder's ``xkv`` from ``build_xattn_cache`` over encoded
    frames, the VLM's patches and prompt in one call; then STEPS single
    ``decode_fn`` steps fed the reference's argmax.  Every call's logits
    (the prefill's cross-attention over the cached K/V takes the chunked
    form, a step's the direct one) and every leaf of the final cache, the
    cross cache passed through unchanged."""
    _, tcfg, rapi, tapi, _, tp = model(arch, dtype)
    inputs, rcalls, rcache = ref_cached(arch, dtype)
    shape = RC.ShapeConfig("c", 24 + tcfg.frontend_len, 2, "decode")
    tc = cache_from_numpy(_zero_cache(rapi, shape, dtype), "cpu")
    kw = {}
    if arch == ENCDEC:
        enc = TT.encoder_forward(tp, torch.from_numpy(inputs["frames"]), tcfg)
        tc["xkv"] = TT.build_xattn_cache(tp, enc, tcfg)
    else:
        kw["patches"] = _t(inputs["patches"])
    xkv = tc.get("xkv")
    with torch.inference_mode():
        logits, tc = TT.decoder_forward(tp, torch.from_numpy(inputs["prompt"]), tcfg, cache=tc,
                                        cache_len=tc["len"], **kw)[:2]
        errs = [rel(logits, rcalls[0])]
        assert tc["len"] == PROMPT + tcfg.frontend_len and tc.get("xkv") is xkv
        for fed, rlog in zip(inputs["fed"], rcalls[1:]):
            logits, tc = tapi.decode_fn(tp, tc, {"tokens": torch.from_numpy(fed)})
            assert logits.shape == rlog.shape == (2, 1, 512)
            errs.append(rel(logits, rlog))
    assert errs[0] <= _tol(dtype) and max(errs[1:]) <= _step_tol(dtype), errs
    flat, rflat = _flat(tc), _flat(rcache)
    assert sorted(flat) == sorted(rflat)
    for k, v in flat.items():
        if k == "/len":
            assert v == int(rflat[k]) == PROMPT + tcfg.frontend_len + STEPS
            continue
        assert str(v.dtype).split(".")[-1] == np.dtype(rflat[k].dtype).name, k
        assert rel(v, rflat[k]) <= _step_tol(dtype), (k, rel(v, rflat[k]))


_GRADS = {}


def _ref_grads(arch):
    """The reference's float32 loss and gradients, compiled once under remat
    ``none`` (the smaller program: remat changes what is saved, not the
    gradients' sums)."""
    if arch not in _GRADS:
        rcfg, _, _, _, pn, _ = model(arch, "float32")
        rapi = ref_build(dataclasses.replace(rcfg, remat="none"))
        b = _batch(arch, seed=11)
        (loss, m), g = jax.jit(jax.value_and_grad(rapi.loss_fn, has_aux=True))(
            pn, jax.tree.map(jnp.asarray, b))
        _GRADS[arch] = (b, loss, m, _flat(jax.tree.map(np.asarray, g)))
    return _GRADS[arch]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch, remat):
    """Float32 ``loss_fn`` gradients against ``jax.value_and_grad``, every
    leaf: the encoder's layers and ``frontend_proj`` (through the cross K/V
    of every decoder layer), ``xattn`` and ``ln_xattn``; the VLM's
    ``frontend_proj`` (through the patch prefix, whose logits the loss
    drops) and the embedding."""
    b, rloss, rm, rgrads = _ref_grads(arch)
    _, tcfg, _, _, _, tp = model(arch, "float32")
    api = build_model(dataclasses.replace(tcfg, remat=remat))
    (loss, m), grads = value_and_grad(api.loss_fn, tp, {k: torch.from_numpy(v)
                                                        for k, v in b.items()})
    assert rel(loss, rloss) <= F32 and sorted(m) == sorted(rm)
    assert int(m["ntok"]) == int(rm["ntok"]) and rel(m["ce"], rm["ce"]) <= F32
    fg, fp = _flat(grads), _flat(tp)
    assert sorted(fg) == sorted(rgrads)
    for k, g in fg.items():
        assert g.dtype == fp[k].dtype and torch.isfinite(g.float()).all(), k
        assert rel(g, rgrads[k]) <= F32_GRAD, (k, rel(g, rgrads[k]))
    key = "/encoder/frontend_proj" if arch == ENCDEC else "/frontend_proj"
    assert float(fg[key].float().abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch, monkeypatch):
    """``greedy_generate`` in float32 (the smoke model's dtype replaced in
    both packages' registries) with the same weights (``draw``, handed to
    the reference in place of its ``materialize``) and the same prompt
    (both draw it from the seed): the same tokens as
    ``repro.launch.serve.greedy_generate``.  As there, the prompt goes
    token by token through ``decode_fn``, the encoder-decoder's cross cache
    stays as ``cache_decl`` makes it (zeros) and no patches are fed."""
    name = f"{arch}-f32"
    monkeypatch.setitem(RC.ARCHS, name, dataclasses.replace(RC.ARCHS[arch], dtype="float32"))
    monkeypatch.setitem(TC.ARCHS, name, dataclasses.replace(TC.ARCHS[arch], dtype="float32"))
    drawn = []

    def numpy_draw(specs, key):
        drawn.append(draw(specs, seed=1))
        return jax.tree.map(jnp.asarray, drawn[-1])

    monkeypatch.setattr(RSERVE, "materialize", numpy_draw)
    out = RSERVE.greedy_generate(name, seed=0)
    assert len(drawn) == 1
    got = greedy_generate(name, seed=0, device="cpu", params=params_from_numpy(drawn[0], "cpu"))
    assert got["generated"].shape == (2, 8) and got["generated"].dtype == np.int32
    assert np.array_equal(got["generated"], out["generated"])
    assert bool(torch.isfinite(got["logits"]).all()) and len(got["step_ms"]) == 16


def test_serve_cli_generates_with_both_archs(capsys):
    for arch in ARCHS:
        assert main(["--device", "cpu", "--arch", arch, "--gen-len", "2"]) == 0
        text = capsys.readouterr().out
        assert "generated tokens" in text
        rows = [ln for ln in text.splitlines() if ln.strip().startswith(("[[", "["))]
        assert len(rows) == 2 and all(len(r.strip("[] ").split()) == 2 for r in rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_decoder_lm_takes_the_frontend_keywords(arch):
    """``DecoderLM`` holds the new leaves under the reference's paths, as
    ``params_from_numpy`` converted them, bit for bit; ``encode(frames)`` is
    ``encoder_forward``, and ``forward`` passes ``patches``, ``enc_out`` and
    ``src_positions`` to ``decoder_forward``: the same logits as the
    reference's forward."""
    _, tcfg, _, _, pn, tp = model(arch, "float32")
    fp = _flat(tp)
    for k, a in _flat(pn).items():
        if "xattn" in k or "frontend" in k or k.startswith("/encoder"):
            bits = a.view(np.int16) if a.dtype.name == "bfloat16" else a
            got = fp[k].view(torch.int16) if fp[k].dtype == torch.bfloat16 else fp[k]
            assert np.array_equal(got.numpy(), bits), k
    b, ref = ref_forward(arch, "float32")
    lm = TT.DecoderLM(tcfg, tp)
    assert sorted(n for n, _ in lm.named_parameters() if "xattn" in n or "frontend" in n) == (
        ["blocks.l0.ln_xattn.bias", "blocks.l0.ln_xattn.scale", "blocks.l0.xattn.wk",
         "blocks.l0.xattn.wo", "blocks.l0.xattn.wq", "blocks.l0.xattn.wv",
         "encoder.frontend_proj"] if arch == ENCDEC else ["frontend_proj"])
    toks = torch.from_numpy(b["tokens"])
    with torch.inference_mode():
        if arch == ENCDEC:
            enc = lm.encode(torch.from_numpy(b["frames"]))
            assert torch.equal(enc, TT.encoder_forward(tp, torch.from_numpy(b["frames"]), tcfg))
            src = torch.arange(SRC, dtype=torch.int32)[None].expand(2, SRC)
            logits, _, _ = lm(toks, enc_out=enc, src_positions=src)
        else:
            logits, _, _ = lm(toks, patches=torch.from_numpy(b["patches"]))
    assert rel(logits, ref["logits"]) <= F32


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_with_the_frontend(arch):
    """``launch.train.train`` on the smoke config: the pipeline's frames or
    patches (``with_frontend``) reach ``loss_fn``, and every step's loss,
    gradient norm and learning rate is finite."""
    out = train(arch, steps=3, log_every=0, device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert all(np.isfinite([h["gnorm"], h["lr"]]).all() for h in out["history"])
    assert int(out["state"]["step"]) == 3
