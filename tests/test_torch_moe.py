"""repro_torch's MoE family (``models.layers.moe_specs``/``apply_moe``, the
decoder's MoE layers and ``first_k_dense`` prefix, their caches, the serve
path) and ``materialize``'s piecewise draw, held against repro's (JAX on the
CPU).

Both packages get the same numpy inputs and the reference's own weights
(``repro.runtime.sharding.materialize(specs, PRNGKey(s))`` -> numpy ->
``params_from_numpy``).  Tolerances are tests/test_torch_models.py's
relative L2 errors: ``F32`` = 1e-5, ``F32_STEP`` = 5e-5 for a decode step,
``BF16`` = 2e-3 for a layer, ``BF16_MODEL`` = 5e-2 for a model.

Routing is a discontinuous function of its input, and the comparisons say
how they deal with it:

* a layer (``apply_moe``) gets the same input in both packages, and its
  routes (expert sets and kept flags) must be equal, in bf16 as in float32;
* a model in float32 must route every token as the reference does, and its
  logits are held to ``F32``/``F32_STEP``;
* a model in bf16 is two different roundings of the same function: where a
  token's K-th and (K+1)-th router probabilities lie within those
  roundings of each other, the two evaluations route it differently (the
  router's input differs by bf16 rounding flips; a flip at a 7-20% gap was
  seen at smoke widths), and that token's later layers and later
  positions follow different experts.  So in bf16 the routes must agree on
  ``ROUTE_AGREE`` of the (token, layer) pairs, the logits of the tokens
  before the first differing route (flat (batch, position) order: a
  difference changes later positions through attention and later bins
  through the capacity count) are held to ``BF16_MODEL``, and the loss
  and aux, means over every token, are held to ``BF16_MODEL`` too.

The model tests rescale the reference's draw of each bf16 weight matrix to
std 1/sqrt(fan-in) (as tests/test_torch_models.py's MLP test does).  Under
the reference's std rule (``scale / sqrt(shape[0])``, 1/sqrt(U) for a
stacked leaf) the smoke models' activations grow ~500x a layer, attention
saturates, and the reference's own jitted and eager bf16 prefills of
kimi-k2's smoke model differ by 27% (relative L2): no bf16 comparison could
mean anything there.  The generation test keeps the reference's own draw,
as ``repro.launch.serve.greedy_generate`` makes it.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import repro.configs as RC
import repro.models.layers as RL
import repro.models.transformer as RT
from repro.launch.serve import greedy_generate as ref_generate
from repro.models import build_model as ref_build
from repro.models.registry import AUX_WEIGHT
from repro.models.registry import cross_entropy as ref_ce
from repro.runtime import sharding as RS

import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.core.galois import fold_in
from repro_torch.launch.serve import greedy_generate, main
from repro_torch.models import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.runtime import sharding as TS

F32, F32_STEP, BF16, BF16_MODEL = 1e-5, 5e-5, 2e-3, 5e-2
ROUTE_AGREE = 0.9
MOE = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
SEQ = 80
CACHE_LEN = 24  # greedy_generate's cache: prompt 8 + gen 8 + 8


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


def _tokens(n, seq, vocab=512, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, seq)).astype(np.int32)


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(RC.ARCHS[arch].smoke(), dtype=dtype, **kw),
            dataclasses.replace(TC.ARCHS[arch].smoke(), dtype=dtype, **kw))


def _fan_in(tree):
    """Each bf16 weight matrix of the reference's draw rescaled from its std
    rule's 1/sqrt(shape[0]) to 1/sqrt(fan-in) (its second-to-last dim); the
    embedding and the float32 router keep theirs."""
    def one(path, a):
        if a.dtype.name != "bfloat16" or a.ndim < 2 or path[0].key == "embed":
            return a
        return np.asarray(jnp.asarray(a.astype(np.float32) * np.sqrt(a.shape[0] / a.shape[-2]),
                                      jnp.bfloat16))
    return jax.tree_util.tree_map_with_path(one, tree)


_DRAWS, _MODELS = {}, {}


def draw(arch):
    """The reference's draw of ``arch``'s smoke weights (``PRNGKey(0)``) as
    numpy; the weights do not depend on the activation dtype."""
    if arch not in _DRAWS:
        specs = ref_build(RC.ARCHS[arch].smoke()).param_specs
        _DRAWS[arch] = jax.tree.map(np.asarray, RS.materialize(specs, jax.random.PRNGKey(0)))
    return _DRAWS[arch]


def model(arch, dtype):
    """(ref cfg, port cfg, ref api, port api, numpy params, port params)."""
    key = (arch, dtype)
    if key not in _MODELS:
        rcfg, tcfg = _cfgs(arch, dtype)
        pn = _fan_in(draw(arch))
        _MODELS[key] = (rcfg, tcfg, ref_build(rcfg), build_model(tcfg), pn,
                        params_from_numpy(pn, "cpu"))
    return _MODELS[key]


_DECODES = {}


def ref_decode(arch, dtype):
    """The reference's jitted ``decode_fn`` for ``model(arch, dtype)``, one
    a model: the bf16 one (the smoke config as published) is compiled once
    for the decode and the generation tests, which share its cache shape."""
    if (arch, dtype) not in _DECODES:
        _DECODES[arch, dtype] = jax.jit(model(arch, dtype)[2].decode_fn)
    return _DECODES[arch, dtype]


# ---------------------------------------------------------------------------
# routing on both sides
# ---------------------------------------------------------------------------


def _ref_routing(p, x, cfg):
    """The reference's routing decisions in ``_apply_moe_dense``, op for op:
    (experts (T, K) in rank order, kept (T, K), the top K + 1 probabilities)."""
    E, K = cfg.num_experts, cfg.experts_per_tok
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, x.shape[-1])
    probs = jax.nn.softmax((xt.astype(jnp.float32) @ p["router"]).astype(jnp.float32), axis=-1)
    top, ids = lax.top_k(probs, min(K + 1, E))
    experts = ids[:, :K]
    C = max(1, int(T * K * cfg.capacity_factor / E))
    flat = experts.reshape(T * K)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, flat[:, None], axis=1)[:, 0]
    return experts, (pos < C).reshape(T, K), top


_REF_LOG = [None]  # the list ref_routes() is filling, None outside it


def _log_ref_routing(*arrays):
    if _REF_LOG[0] is not None:
        _REF_LOG[0].append(tuple(np.asarray(a) for a in arrays))


@contextlib.contextmanager
def ref_routes():
    """Every reference MoE layer call's routing, in call order, also under
    ``jit`` and ``lax.scan``: an ordered host callback beside each call of a
    function traced inside this block (a compiled function keeps its
    callback and logs into whichever block it is called in)."""
    orig = RT.apply_moe

    def recorded(p, x, cfg):
        jax.debug.callback(_log_ref_routing, *_ref_routing(p, x, cfg), ordered=True)
        return orig(p, x, cfg)

    RT.apply_moe, _REF_LOG[0] = recorded, []
    try:
        yield _REF_LOG[0]
    finally:
        jax.effects_barrier()
        RT.apply_moe, _REF_LOG[0] = orig, None


def _route_sets(experts, kept):
    """Each token's routes as a set: (expert, kept) pairs sorted by expert
    (the rank order among a token's own experts changes no bin)."""
    experts, kept = np.asarray(experts), np.asarray(kept)
    order = np.argsort(experts, axis=1, kind="stable")
    return np.take_along_axis(experts, order, 1), np.take_along_axis(kept, order, 1)


def _route_diff(ref_calls, port_calls):
    """(tokens whose route sets differ in any call, flat index of the first,
    share of (token, call) pairs that agree)."""
    assert len(ref_calls) == len(port_calls)
    bad = np.zeros(len(ref_calls[0][0]), bool)
    agree = []
    for (re, rk, _), r in zip(ref_calls, port_calls):
        (a, ak), (b, bk) = _route_sets(re, rk), _route_sets(r.experts, r.kept)
        d = (a != b).any(1) | (ak != bk).any(1)
        bad |= d
        agree.append(1 - d.mean())
    first = int(np.argmax(bad)) if bad.any() else len(bad)
    return bad, first, float(np.mean(agree))


# ---------------------------------------------------------------------------
# specs and conversion
# ---------------------------------------------------------------------------


def _same_decl(r, t):
    rl, tl = list(RS._leaf_paths(r)), list(TS._leaf_paths(t))
    assert [(p, s.shape, s.logical, s.init, s.scale) for p, s in tl] == \
        [(p, s.shape, s.logical, s.init, s.scale) for p, s in rl]
    assert [str(s.dtype).split(".")[-1] for _, s in tl] == [jnp.dtype(s.dtype).name for _, s in rl]


@pytest.mark.parametrize("arch", MOE)
def test_specs_match_reference_at_full_width(arch):
    """Parameters, caches (the prefix's included) and batches as the
    reference declares them, at the published widths; nothing is drawn."""
    rapi, tapi = ref_build(RC.ARCHS[arch]), build_model(TC.ARCHS[arch])
    _same_decl(rapi.param_specs, tapi.param_specs)
    assert TS.param_count(tapi.param_specs) == RS.param_count(rapi.param_specs)
    assert TS.param_bytes(tapi.param_specs) == RS.param_bytes(rapi.param_specs)
    for shape in [RC.smoke_shape(k) for k in ("train", "prefill", "decode")]:
        tshape = TC.ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        _same_decl(rapi.cache_decl(shape), tapi.cache_decl(tshape))
        _same_decl(rapi.batch_specs(shape), tapi.batch_specs(tshape))
    moe = tapi.param_specs["blocks"]["l0"]["moe"]
    assert moe["router"].dtype == torch.float32
    if arch == "qwen3-moe-30b-a3b":  # 30.22 B parameters, 60.4 GB in bf16, one card
        assert round(TS.param_count(tapi.param_specs) / 1e9, 2) == 30.22
        assert moe["w_gate"].shape == (48, 128, 2048, 768)
    else:  # the dense prefix layer and the shared expert
        assert set(tapi.param_specs["prefix"]) == {"p0"}
        assert moe["shared"]["w_in"].shape == (60, 7168, 2048)
        assert "prefix" in tapi.cache_decl(TC.ShapeConfig("d", 16, 2, "decode"))


def test_convert_is_bit_exact():
    """kimi-k2's smoke tree: prefix, experts, shared expert, float32 router."""
    pn = draw("kimi-k2-1t-a32b")
    tp = params_from_numpy(pn, "cpu")
    paths = [p for p, _ in RS._leaf_paths(pn)]
    assert ("prefix", "p0", "mlp", "w_gate") in paths and ("blocks", "l0", "moe", "router") in paths
    for (path, a), (tpath, b) in zip(RS._leaf_paths(pn), TS._leaf_paths(tp)):
        assert path == tpath
        assert b.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32), path
        assert np.array_equal(b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 else b.numpy(),
                              a.view(np.int16) if a.dtype.name == "bfloat16" else a), path


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _moe_case(dtype, act, shared, cf, rng_seed=5):
    rcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", dtype, mlp_act=act, shared_experts=shared,
                       capacity_factor=cf, experts_per_tok=3)
    # drawn with numpy: experts at 1/sqrt(fan-in) so their activations
    # reach GELU's curved range; the router at 1/d, its logits O(1)
    rng = np.random.default_rng(rng_seed)
    p = RS._map_leaves(lambda path, ps: np.asarray(jnp.asarray(
        rng.standard_normal(ps.shape) / (rcfg.d_model if path[-1] == "router"
                                         else np.sqrt(ps.shape[-2])), ps.dtype)),
        RL.moe_specs(rcfg))
    x = (rng.standard_normal((2, 9, rcfg.d_model)) * 2).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    return rcfg, tcfg, p, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("cf,shared", [(1.25, 1), (8.0, 0)], ids=["drops-shared", "no-drops"])
def test_apply_moe(cf, shared, act, dtype):
    """18 tokens, 8 experts, top-3: output, aux and the kept routes against
    ``_apply_moe_dense``; at capacity factor 1.25 (C = 8) routes drop, and
    a shared expert adds its MLP; at 8.0 (C = 54) none drops."""
    rcfg, tcfg, p, x = _moe_case(dtype, act, shared, cf)
    with TL.recording_routes() as routes:
        out, aux = TL.apply_moe(params_from_numpy(p, "cpu"), _t(x), tcfg)
    ref, raux = RL._apply_moe_dense(p, jnp.asarray(x), rcfg)
    assert out.dtype == tcfg.adtype and out.shape == ref.shape
    assert rel(out, ref) <= (F32 if dtype == "float32" else BF16)
    assert aux.dtype == torch.float32 and rel(aux, raux) <= F32
    (r,) = routes
    re, rk, rtop = (np.asarray(a) for a in _ref_routing(p, jnp.asarray(x), rcfg))
    assert np.array_equal(r.experts.numpy(), re) and np.array_equal(r.kept.numpy(), rk)
    assert np.allclose(r.top.numpy(), rtop, rtol=1e-6)
    assert (not rk.all()) if cf == 1.25 else rk.all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_router_breaks_ties_to_the_lower_index(dtype):
    """Every probability tied: both packages send every token to experts
    0..K-1 and keep the first C routes of each, in token order."""
    rcfg, tcfg, p, x = _moe_case(dtype, "swiglu", 0, 1.25)
    p["router"] = np.zeros_like(p["router"])
    with TL.recording_routes() as routes:
        out, aux = TL.apply_moe(params_from_numpy(p, "cpu"), _t(x), tcfg)
    ref, raux = RL._apply_moe_dense(p, jnp.asarray(x), rcfg)
    (r,) = routes
    K, T, C = tcfg.experts_per_tok, 18, 8
    assert np.array_equal(r.experts.numpy(), np.broadcast_to(np.arange(K), (T, K)))
    assert np.array_equal(r.kept.numpy(), np.asarray(_ref_routing(p, jnp.asarray(x), rcfg)[1]))
    assert r.kept.numpy().all(1).tolist() == [t < C for t in range(T)]
    assert rel(out, ref) <= (F32 if dtype == "float32" else BF16)
    assert float(aux) == float(raux)  # E * K * (1/E) exactly


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def _held_in_bf16(bad, first, agree, port, ref):
    """bf16's routing-aware hold (see the module docstring)."""
    assert agree >= ROUTE_AGREE, agree
    if first:
        T = len(bad)
        port, ref = port.reshape(T, -1)[:first], np.asarray(ref).reshape(T, -1)[:first]
        assert rel(port, ref) <= BF16_MODEL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_loss(arch, dtype):
    """``decoder_forward`` over 2 x 80 tokens (logits, aux), ``prefill_fn``
    and ``loss_fn``'s forward (ce, aux, total = ce + 0.01 aux); kimi-k2 runs
    its dense prefix layer and its shared expert."""
    rcfg, tcfg, rapi, tapi, pn, tp = model(arch, dtype)
    toks, labels = _tokens(2, SEQ), _tokens(2, SEQ, seed=9)
    labels[1, :3] = -1
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}

    def ref(p, b):  # the forward, then loss_fn's body on its logits and aux
        logits, _, aux = RT.decoder_forward(p, b["tokens"], rcfg)
        ce, ntok = ref_ce(logits, b["labels"])
        return logits, aux, ce + AUX_WEIGHT * aux, {"ce": ce, "aux": aux, "ntok": ntok}

    with ref_routes() as rr:
        rlog, raux, rtotal, rm = jax.jit(ref)(pn, batch)
        rlog = np.asarray(rlog)
    with TL.recording_routes() as tr:
        logits, cache, aux = TT.decoder_forward(tp, torch.from_numpy(toks), tcfg)
    assert cache is None and logits.dtype == torch.float32 and logits.shape == rlog.shape
    assert len(tr) == len(rr) == TT.num_units(tcfg)
    bad, first, agree = _route_diff(rr, tr)
    if dtype == "float32":
        assert not bad.any()
        assert rel(logits, rlog) <= F32
    else:
        _held_in_bf16(bad, first, agree, logits, rlog)
    tol = F32 if dtype == "float32" else BF16_MODEL
    assert rel(aux, raux) <= tol
    pre = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(pre, logits[:, -1:])
    total, m = tapi.loss_fn(tp, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert int(m["ntok"]) == int(rm["ntok"]) == 2 * SEQ - 3
    for got, want in ((total, rtotal), (m["ce"], rm["ce"]), (m["aux"], rm["aux"])):
        assert rel(got, want) <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_decode_steps(arch, dtype):
    """12 cached decode steps at batch 2 (C = 1: two tokens choosing one
    expert drop the second's route), from a zero cache (float32 in float32,
    the declared bf16 otherwise), kimi-k2's prefix cache included: every
    step's logits and routes, and the caches at the end."""
    rcfg, tcfg, rapi, tapi, pn, tp = model(arch, dtype)
    steps = 12
    decl = rapi.cache_decl(RC.ShapeConfig("s", CACHE_LEN, 2, "decode"))
    cdt = jnp.float32 if dtype == "float32" else None
    rc = jax.tree.map(lambda ps: jnp.zeros(ps.shape, cdt if cdt and ps.shape else ps.dtype),
                      decl, is_leaf=lambda x: isinstance(x, RS.ParamSpec))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    decode = ref_decode(arch, dtype)
    toks = _tokens(2, steps, seed=1)
    held, drops, diverged = 0, 0, False
    for i in range(steps):
        with ref_routes() as rr:
            rlog, rc = decode(pn, rc, {"tokens": jnp.asarray(toks[:, i:i + 1])})
        with TL.recording_routes() as tr:
            tlog, tc = tapi.decode_fn(tp, tc, {"tokens": torch.from_numpy(toks[:, i:i + 1])})
        assert tlog.shape == rlog.shape == (2, 1, tcfg.vocab_size)
        bad, first, agree = _route_diff(rr, tr)
        drops += sum(int((~r.kept).sum()) for r in tr)
        if dtype == "float32":
            assert not bad.any(), i
            assert rel(tlog, rlog) <= F32_STEP, i
        else:
            assert agree >= 0.5, (i, agree)  # a step is 2 tokens
            diverged = diverged or bad.any()
            if not diverged:
                assert rel(tlog, rlog) <= BF16_MODEL, i
                held += 1
    assert tc["len"] == int(rc["len"]) == steps
    assert drops > 0
    if dtype == "float32":
        assert rel(tc["l0"]["k"], rc["l0"]["k"]) <= F32_STEP
        assert rel(tc["l0"]["v"], rc["l0"]["v"]) <= F32_STEP
        if tcfg.first_k_dense:
            assert tc["prefix"]["p0"]["k"].dtype == torch.float32
            assert rel(tc["prefix"]["p0"]["k"], rc["prefix"]["p0"]["k"]) <= F32_STEP
            assert rel(tc["prefix"]["p0"]["v"], rc["prefix"]["p0"]["v"]) <= F32_STEP
    else:
        assert held >= 1


@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_matches_reference(arch):
    """``greedy_generate`` (bf16 smoke, the reference's own draw and prompt)
    against ``repro.launch.serve.greedy_generate``.  The reference's
    sequence teacher-forced through both decode paths gives each step's
    logits and routes; a generated token must equal the reference's up to
    the first step whose routes differ, wherever the reference's top-2 gap
    exceeds twice the largest difference between the two steps' logits in
    that row (no such difference can reorder them), and the routes of the
    teacher-forced steps must agree on ``ROUTE_AGREE`` of the (token,
    layer) pairs (qwen3's first differ at step 7).  The logits themselves
    are held by ``test_decode_steps``: under the reference's std rule
    kimi-k2's bf16 steps differ by 5.5% before any route does (see the
    module docstring)."""
    rapi = model(arch, "bfloat16")[2]  # the smoke config as published
    params = draw(arch)
    out = ref_generate(arch, seed=0)
    tp = params_from_numpy(params, "cpu")
    got = greedy_generate(arch, seed=0, device="cpu", params=tp)
    assert got["generated"].shape == (2, 8) and got["generated"].dtype == np.int32
    assert bool(torch.isfinite(got["logits"]).all())
    seq = np.concatenate([got["prompt"], out["generated"]], axis=1).astype(np.int32)
    tapi = build_model(TC.ARCHS[arch].smoke())
    decl = rapi.cache_decl(RC.ShapeConfig("serve", CACHE_LEN, 2, "decode"))
    rc = jax.tree.map(lambda ps: jnp.zeros(ps.shape, ps.dtype), decl,
                      is_leaf=lambda x: isinstance(x, RS.ParamSpec))
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    decode = ref_decode(arch, "bfloat16")
    same_until, rows, agree = seq.shape[1], [], []
    for t in range(seq.shape[1]):
        with ref_routes() as rr:
            rlog, rc = decode(params, rc, {"tokens": jnp.asarray(seq[:, t:t + 1])})
        with torch.inference_mode(), TL.recording_routes() as tr:
            tlog, tc = tapi.decode_fn(tp, tc, {"tokens": torch.from_numpy(seq[:, t:t + 1])})
        ref = np.asarray(rlog[:, -1], np.float64)
        rows.append((ref, np.abs(tlog[:, -1].double().numpy() - ref).max(-1)))
        bad, _, share = _route_diff(rr, tr)
        agree.append(share)
        if same_until == seq.shape[1] and bad.any():
            same_until = t
    assert np.mean(agree) >= ROUTE_AGREE, agree
    for b in range(2):
        for j in range(8):
            step = 7 + j  # the step whose logits chose generated token j
            ref, err = rows[step]
            top2 = np.sort(ref[b])[-2:]
            if step >= same_until or top2[1] - top2[0] <= 2 * err[b]:
                break
            assert got["generated"][b, j] == out["generated"][b, j], (b, j)


def test_serve_cli_generates_with_the_moe_archs(capsys):
    for arch in MOE:
        assert main(["--device", "cpu", "--arch", arch, "--gen-len", "2"]) == 0
        text = capsys.readouterr().out
        assert "generated tokens" in text
        rows = [ln for ln in text.splitlines() if ln.strip().startswith(("[[", "["))]
        assert len(rows) == 2 and all(len(r.strip("[] ").split()) == 2 for r in rows)


# ---------------------------------------------------------------------------
# materialize: leaves past the piecewise size
# ---------------------------------------------------------------------------


def test_materialize_draws_large_leaves_by_slices(monkeypatch):
    """A leaf past ``PIECEWISE_BYTES`` is drawn a leading slice at a time,
    slice i from ``fold_in(leaf seed, i)`` (again by slices where a slice
    is still too large), with the reference's std rule for the whole leaf;
    leaves under the size keep their bits."""
    specs = {"big": TS.ParamSpec((6, 64, 96), (None, None, None)),
             "huge": TS.ParamSpec((2, 4, 32, 64), (None, None, None, None), scale=3.0),
             "small": TS.ParamSpec((48, 40), (None, None)),
             "router": TS.ParamSpec((40, 8), (None, None), torch.float32)}
    cut = 4 * 64 * 96  # "big"'s slice is drawn whole, "huge"'s by rows of slices
    whole = TS.materialize(specs, 11, device="cpu")
    monkeypatch.setattr(TS, "PIECEWISE_BYTES", cut)
    piece = TS.materialize(specs, 11, device="cpu")
    again = TS.materialize(specs, 11, device="cpu")
    for name, ps in specs.items():
        seed = TS._path_seed(11, (name,))
        std = ps.scale / np.sqrt(ps.shape[0])
        g = torch.Generator().manual_seed(seed)
        flat = (torch.randn(ps.shape, generator=g) * float(std)).to(ps.dtype)
        assert torch.equal(whole[name], flat), name  # the whole draw's bits
        assert torch.equal(piece[name], again[name]) and piece[name].dtype == ps.dtype
        if name in ("small", "router"):
            assert torch.equal(piece[name], flat), name
            continue
        assert not torch.equal(piece[name], flat)
        x = piece[name].float()
        assert abs(x.std().item() / std - 1) < 0.03 and abs(x.mean().item()) < 0.03 * std, name
        # each slice its own stream: slice 1 of "big" is slice 1's own draw
        g = torch.Generator().manual_seed(fold_in(seed, 1))
        want = (torch.randn(ps.shape[1:], generator=g) * float(std)).to(ps.dtype)
        if name == "big":
            assert torch.equal(piece[name][1], want)
        else:  # a slice past the size is drawn by its own slices
            g = torch.Generator().manual_seed(fold_in(fold_in(seed, 1), 2))
            want = (torch.randn(ps.shape[2:], generator=g) * float(std)).to(ps.dtype)
            assert torch.equal(piece[name][1, 2], want)
    assert not torch.equal(piece["big"][0], piece["big"][1])


def test_materialize_keeps_every_gemma2_leaf_whole():
    """Every gemma2-2b leaf, at its published size, is under the piecewise
    size, so its draw (and bits) are those of the whole-leaf draw; the
    stacked experts of qwen3-moe-30b-a3b are over it."""
    big = lambda arch: max(int(np.prod(ps.shape)) * 4 for _, ps in
                           TS._leaf_paths(build_model(TC.ARCHS[arch]).param_specs))
    assert big("gemma2-2b") == 256000 * 2304 * 4 < TS.PIECEWISE_BYTES
    assert big("qwen3-moe-30b-a3b") == 48 * 128 * 2048 * 768 * 4 > TS.PIECEWISE_BYTES
    assert 128 * 2048 * 768 * 4 < TS.PIECEWISE_BYTES
