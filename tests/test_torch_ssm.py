"""repro_torch's SSM family (``models.layers.ssd_specs``/``_ssd_scan``/
``apply_ssd``, ``models.ssm``'s mamba2 and zamba2, their registry entries,
caches and the serve path) held against repro's (JAX on the CPU).

Both packages get the same numpy inputs.  Weights are drawn with numpy from
a seed (``draw``): every matrix at std 1/sqrt(fan-in), and the leaves whose
init is a constant (``A_log``, ``dt_bias``, ``D``, the norms' scales) at
random, so that no two SSD heads are alike and a mix-up of the head axis
shows.  Both sides run with ``ssm_chunk`` = 16 (``CHUNK``), so an 80-token
prefill scans 5 chunks and a 72-token one halves the chunk to 8 (9 chunks).  The
generation test keeps the reference's own draw, as
``repro.launch.serve.greedy_generate`` makes it.

Tolerances are tests/test_torch_train.py's relative L2 errors:
``F32`` = 1e-5, ``F32_STEP`` = 5e-5 for a cached call, ``F32_GRAD`` = 2e-3
for a gradient leaf (bf16 matrices: their gradients are float32 gradients
rounded to bf16), ``BF16_MODEL`` = 5e-2 for anything computed in bf16.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.models.layers as RL
import repro.models.ssm as RSSM
from repro.launch.serve import greedy_generate as ref_generate
from repro.models import build_model as ref_build
from repro.models.registry import cross_entropy as ref_ce
from repro.runtime import sharding as RS

import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.ssm as TSSM
from repro_torch.launch.serve import greedy_generate, main
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model
from repro_torch.models.convert import cache_from_numpy, params_from_numpy
from repro_torch.runtime import sharding as TS

F32, F32_STEP, F32_GRAD, BF16_MODEL = 1e-5, 5e-5, 2e-3, 5e-2
SSM = ["mamba2-370m", "zamba2-7b"]
DTYPES = ["float32", "bfloat16"]
CHUNK = 16
SEQ = 80  # 5 chunks of 16
# cached calls: three single steps, a 24-token call continuing from their
# state (the chunk halved to 8), then four single steps
SPANS = [1, 1, 1, 24, 1, 1, 1, 1]


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
    std 1/sqrt(fan-in), the embedding at std 1, ``A_log`` in [-1, 1.5),
    ``dt_bias`` in [-3, 0), ``D`` and every norm scale in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def one(path, ps):
        name, shape = path[-1], ps.shape
        if name == "A_log":
            a = rng.uniform(-1.0, 1.5, shape)
        elif name == "dt_bias":
            a = rng.uniform(-3.0, 0.0, shape)
        elif name in ("D", "scale"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "embed":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return np.asarray(jnp.asarray(a, ps.dtype))

    return RS._map_leaves(one, specs)


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(RC.ARCHS[arch].smoke(), dtype=dtype, ssm_chunk=CHUNK, **kw),
            dataclasses.replace(TC.ARCHS[arch].smoke(), dtype=dtype, ssm_chunk=CHUNK, **kw))


def _tokens(n, seq, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, seq)).astype(np.int32)


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


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _same_decl(r, t):
    rl, tl = list(RS._leaf_paths(r)), list(TS._leaf_paths(t))
    assert [(p, s.shape, s.logical, s.init, s.scale) for p, s in tl] == \
        [(p, s.shape, s.logical, s.init, s.scale) for p, s in rl]
    assert [str(s.dtype).split(".")[-1] for _, s in tl] == [jnp.dtype(s.dtype).name for _, s in rl]


@pytest.mark.parametrize("arch", SSM)
def test_specs_match_reference_at_full_width(arch):
    """Parameters, caches and batches as the reference declares them, at
    the published widths and depths (nothing is drawn): mamba2-370m's 0.368
    B parameters; zamba2-7b's 6.66 B, 13 units of 6 SSD layers, 3 tail
    layers and one shared block of 0.231 B."""
    rapi, tapi = ref_build(RC.ARCHS[arch]), build_model(TC.ARCHS[arch])
    _same_decl(rapi.param_specs, tapi.param_specs)
    assert TS.param_count(tapi.param_specs) == RS.param_count(rapi.param_specs)
    assert TS.param_bytes(tapi.param_specs) == RS.param_bytes(rapi.param_specs)
    for shape in [RC.smoke_shape(k) for k in ("train", "prefill", "decode")]:
        tshape = TC.ShapeConfig(shape.name, shape.seq_len, shape.global_batch, shape.kind)
        _same_decl(rapi.cache_decl(shape), tapi.cache_decl(tshape))
        _same_decl(rapi.batch_specs(shape), tapi.batch_specs(tshape))
    n = TS.param_count(tapi.param_specs)
    decl = tapi.cache_decl(TC.ShapeConfig("d", 16, 2, "decode"))
    assert decl["state"].dtype == torch.float32 and decl["conv"].dtype == torch.bfloat16
    if arch == "mamba2-370m":
        assert round(n / 1e9, 3) == 0.368 and "len" not in decl
        assert tapi.param_specs["blocks"]["ssd"]["A_log"].shape == (48, 32)
    else:
        assert round(n / 1e9, 2) == 6.66 and set(tapi.param_specs["tail"]) == {"t0", "t1", "t2"}
        assert round(TS.param_count(tapi.param_specs["shared"]) / 1e9, 3) == 0.231
        assert tapi.param_specs["blocks"]["m5"]["ssd"]["A_log"].shape == (13, 112)
        assert decl["shared_k"].shape == (13, 2, 16, 32, 112) and "len" in decl


# ---------------------------------------------------------------------------
# the SSD layer
# ---------------------------------------------------------------------------


def _ssd_case(dtype, seed=3):
    rcfg, tcfg = _cfgs("mamba2-370m", dtype)
    p = draw(RL.ssd_specs(rcfg), seed)
    return rcfg, tcfg, p, np.random.default_rng(seed)


def _act(rng, shape, dtype, scale=1.0):
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * scale,
                                  jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("branch", ["scan", "continue", "step"])
def test_apply_ssd(branch, dtype):
    """``apply_ssd``'s three branches against the reference's (jitted): no
    cache (80 tokens, 5 chunks of 16), ``S > 1`` continuing the chunked
    scan from a random cached state and conv history (72 tokens: the chunk
    halved to 8), and the one-step float32 recurrence; the output and the
    new cache.  In float32 the declared bf16 conv history is promoted to
    float32, as ``concatenate`` promotes it."""
    rcfg, tcfg, p, rng = _ssd_case(dtype)
    S = {"scan": SEQ, "continue": 72, "step": 1}[branch]
    assert TL._scan_chunk(tcfg, S) == {"scan": 16, "continue": 8, "step": 1}[branch]
    x = _act(rng, (2, S, rcfg.d_model), dtype)
    cache = None
    if branch != "scan":
        H, cd = rcfg.ssm_d_inner // rcfg.ssm_head_dim, rcfg.ssm_d_inner + 2 * rcfg.ssm_state
        cache = {"conv": _act(rng, (2, rcfg.ssm_conv - 1, cd), "bfloat16"),
                 "state": rng.standard_normal((2, H, rcfg.ssm_state, rcfg.ssm_head_dim))
                 .astype(np.float32)}
    out, nc = TL.apply_ssd(params_from_numpy(p, "cpu"), _t(x), tcfg,
                           cache=None if cache is None else params_from_numpy(cache, "cpu"))
    ref, rnc = jax.jit(lambda p, x, c: RL.apply_ssd(p, x, rcfg, cache=c))(
        p, jnp.asarray(x), None if cache is None else jax.tree.map(jnp.asarray, cache))
    assert out.dtype == tcfg.adtype and out.shape == ref.shape
    assert rel(out, ref) <= _tol(dtype)
    if cache is None:
        assert nc is None and rnc is None
        return
    assert nc["state"].dtype == torch.float32 and rel(nc["state"], rnc["state"]) <= _tol(dtype)
    assert str(nc["conv"].dtype).split(".")[-1] == jnp.dtype(rnc["conv"].dtype).name == dtype
    assert rel(nc["conv"], rnc["conv"]) <= _tol(dtype)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", SSM)
def test_prefill_and_loss(arch, dtype):
    """The forward over 2 x 72 tokens (9 chunks of 8 a layer: the chunk
    halved), ``prefill_fn`` and ``loss_fn`` over the same tokens: logits,
    ce, ntok and no aux (mamba2's logits through ``softcap`` in float32,
    zamba2's in the activation dtype)."""
    rcfg, tcfg, rapi, tapi, pn, tp = model(arch, dtype)
    toks, labels = _tokens(2, 72, seed=5), _tokens(2, 72, seed=9)
    labels[1, :3] = -1
    rfwd = RSSM.mamba_forward if arch == "mamba2-370m" else RSSM.zamba_forward
    forward = TSSM.mamba_forward if arch == "mamba2-370m" else TSSM.zamba_forward
    # the reference's loss_fn is its forward and ``cross_entropy``: traced
    # once here (its metrics are held in the gradient test)
    rlog, (rloss, rntok) = jax.jit(lambda p, t, l: (lambda lg: (lg, ref_ce(lg, l)))(
        rfwd(p, t, rcfg)[0]))(pn, jnp.asarray(toks), jnp.asarray(labels))
    logits, cache, aux = forward(tp, torch.from_numpy(toks), tcfg)
    assert cache is None and float(aux) == 0.0 and logits.shape == (2, 72, 512)
    assert logits.dtype == (torch.float32 if arch == "mamba2-370m" else tcfg.adtype)
    assert rel(logits, rlog) <= _tol(dtype)
    pre = tapi.prefill_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(pre, logits[:, -1:])
    loss, m = tapi.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
    assert sorted(m) == ["ce", "ntok"]
    assert int(m["ntok"]) == int(rntok) == 2 * 72 - 3
    assert rel(loss, rloss) <= _tol(dtype) and torch.equal(loss, m["ce"])


def _zero_cache(rapi, shape, dtype):
    """The declared cache as zeros, the shared block's k and v in the
    activation dtype (float32 attention stays float32); the conv history
    as declared (bf16)."""
    decl = rapi.cache_decl(shape)
    kv = jnp.float32 if dtype == "float32" else None

    def one(path, ps):
        dt = kv if kv is not None and path[0] in ("shared_k", "shared_v") else ps.dtype
        return jnp.zeros(ps.shape, dt)

    return RS._map_leaves(one, decl)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", SSM)
def test_cached_decode(arch, dtype):
    """``decode_fn`` from a zero cache: three single steps, a 24-token call
    continuing from their state (``S > 1``: the scan from the cached state,
    the chunk halved to 8), four single steps; every call's logits, and
    every leaf of the final cache (the conv history promoted to float32 in
    a float32 model; zamba2's ``len`` advanced by each call's S)."""
    rcfg, tcfg, rapi, tapi, pn, tp = model(arch, dtype)
    rc = _zero_cache(rapi, RC.ShapeConfig("s", 40, 2, "decode"), dtype)
    tc = cache_from_numpy(jax.tree.map(np.asarray, rc), "cpu")
    decode = jax.jit(rapi.decode_fn)
    toks = _tokens(2, sum(SPANS), seed=1)
    at = 0
    for i, S in enumerate(SPANS):
        batch = toks[:, at:at + S]
        rlog, rc = decode(pn, rc, {"tokens": jnp.asarray(batch)})
        tlog, tc2 = tapi.decode_fn(tp, tc, {"tokens": torch.from_numpy(batch)})
        assert tlog.shape == rlog.shape == (2, S, 512)
        assert rel(tlog, rlog) <= _step_tol(dtype), (i, rel(tlog, rlog))
        if arch == "mamba2-370m":
            assert tc2["state"] is not tc["state"] and "len" not in tc2
        else:
            assert tc2["shared_k"] is tc["shared_k"] and tc2["len"] == at + S
        tc, at = tc2, at + S
    flat, rflat = _flat(tc), _flat(jax.tree.map(np.asarray, rc))
    assert sorted(flat) == sorted(rflat)
    for k, v in flat.items():
        if k == "/len":
            assert v == int(rflat[k]) == at
            continue
        assert str(v.dtype).split(".")[-1] == np.dtype(rflat[k].dtype).name, k
        assert rel(v, rflat[k]) <= _step_tol(dtype), (k, rel(v, rflat[k]))
    assert tc["conv" if arch == "mamba2-370m" else "tail_conv"].dtype == tcfg.adtype


_GRADS = {}


def _ref_grads(arch):
    """The reference's float32 loss and gradients (its published remat)."""
    if arch not in _GRADS:
        rcfg, _, rapi, _, pn, _ = model(arch, "float32")
        toks, labels = _tokens(2, SEQ, seed=11), _tokens(2, SEQ, seed=12)
        labels[0, :3] = -1
        batch = {"tokens": toks, "labels": labels}
        (loss, m), g = jax.jit(jax.value_and_grad(rapi.loss_fn, has_aux=True))(
            pn, jax.tree.map(jnp.asarray, batch))
        _GRADS[arch] = (batch, loss, m, _flat(jax.tree.map(np.asarray, g)))
    return _GRADS[arch]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", SSM)
def test_loss_and_gradients_match_jax_value_and_grad(arch, remat):
    """Float32 ``loss_fn`` gradients through 5 chunks a layer against
    ``jax.value_and_grad``, every leaf: the SSD's ``A_log``, ``dt_bias``,
    ``D``, conv and projections, zamba2's shared block (the sum over its
    uses) and the embedding (through ``x0`` and the tied head)."""
    batch, rloss, rm, rgrads = _ref_grads(arch)
    _, tcfg, _, _, _, tp = model(arch, "float32")
    api = build_model(dataclasses.replace(tcfg, remat=remat))
    (loss, m), grads = value_and_grad(api.loss_fn, tp, {k: torch.from_numpy(v)
                                                        for k, v in batch.items()})
    assert rel(loss, rloss) <= F32 and sorted(m) == sorted(rm) == ["ce", "ntok"]
    assert int(m["ntok"]) == int(rm["ntok"]) and rel(m["ce"], rm["ce"]) <= F32
    fg = _flat(grads)
    assert sorted(fg) == sorted(rgrads)
    for k, g in fg.items():
        assert torch.isfinite(g.float()).all(), k
        assert rel(g, rgrads[k]) <= F32_GRAD, (k, rel(g, rgrads[k]))
    if arch == "zamba2-7b":
        assert float(fg["/shared/proj_in"].float().abs().sum()) > 0


@pytest.mark.parametrize("arch", SSM)
def test_greedy_generate_matches_reference(arch, monkeypatch):
    """``greedy_generate`` in float32 (the smoke model's dtype replaced in
    both packages' registries) with the reference's own draw and prompt:
    the same tokens as ``repro.launch.serve.greedy_generate``."""
    name = f"{arch}-f32"
    monkeypatch.setitem(RC.ARCHS, name, dataclasses.replace(RC.ARCHS[arch], dtype="float32"))
    monkeypatch.setitem(TC.ARCHS, name, dataclasses.replace(TC.ARCHS[arch], dtype="float32"))
    out = ref_generate(name, seed=0)
    specs = ref_build(RC.ARCHS[name].smoke()).param_specs
    params = jax.tree.map(np.asarray, RS.materialize(specs, jax.random.PRNGKey(0)))
    got = greedy_generate(name, seed=0, device="cpu", params=params_from_numpy(params, "cpu"))
    assert got["generated"].shape == (2, 8) and got["generated"].dtype == np.int32
    assert np.array_equal(got["generated"], out["generated"])
    assert bool(torch.isfinite(got["logits"]).all()) and len(got["step_ms"]) == 16


def test_serve_cli_generates_with_the_ssm_archs(capsys):
    for arch in SSM:
        assert main(["--device", "cpu", "--arch", arch, "--gen-len", "2"]) == 0
        text = capsys.readouterr().out
        assert "generated tokens" in text
        rows = [ln for ln in text.splitlines() if ln.strip().startswith(("[[", "["))]
        assert len(rows) == 2 and all(len(r.strip("[] ").split()) == 2 for r in rows)
