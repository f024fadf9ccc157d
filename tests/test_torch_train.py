"""The port's training step held against the reference's (JAX on the CPU):
``loss_fn``'s value and gradients against ``jax.value_and_grad`` of the
reference's ``loss_fn``, under every remat mode, and ``build_cell``'s train
step with ``grad_accum = 2``.

Both packages get the reference's weights (``materialize`` -> numpy ->
``params_from_numpy``) and the same numpy tokens; the reference runs under
``jax.jit`` with its published remat (``"full"``).  Tolerances, relative L2
per output, ||port - ref|| / ||ref||:

* float32: the loss ``F32`` = 1e-5; each gradient leaf ``F32_GRAD`` = 2e-3.
  The smoke models' stacked weights have std 1/sqrt(U) = 1 (the
  reference's std rule), so activations grow ~10x a matmul and one-ulp
  differences grow with them through the backward (float32 leaves, the norm
  scales, differ by up to 2e-4); the matrices are bf16, so their gradients
  are float32 gradients rounded to bf16, where a rounding flip costs 2^-8,
  and the embedding's gather accumulates duplicate tokens in bf16 in
  another order (up to 9e-4).
* bf16 models: each gradient leaf within ``BF16_MODEL`` = 5e-2 of the
  reference's, or within half the reference's own bf16 error on that leaf
  (its bf16 gradient against its float32 gradient, same weights and
  tokens), whichever is larger: at the smoke models' activation scales the
  reference's bf16 gradients are 2-170% from its float32 ones, and the
  port's bf16 rounding flips (summation order) grow the same way.  The bf16
  loss is held to ``BF16_MODEL``.
* remat: in float32 the port's gradients under ``"full"`` and ``"dots"``
  equal those under ``"none"`` to ``REMAT`` = 1e-6 (the recomputed forward
  is the same computation; only summation order may differ).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.launch.steps import build_cell as ref_build_cell
from repro.models import build_model as ref_build
from repro.runtime import sharding as RS

import repro_torch.configs as TC
from repro_torch.launch.steps import build_cell, value_and_grad
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

F32, F32_GRAD, BF16_MODEL, REMAT = 1e-5, 2e-3, 5e-2, 1e-6
SEQ = 80  # longer than the smoke window of 64, so local layers mask
REMATS = ["none", "full", "dots"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    a = port.detach().double().cpu().numpy()
    b = np.asarray(ref).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _batch(n=2, seq=SEQ, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # ignored
    return {"tokens": toks[:, :-1], "labels": labels}


_REF = {}


def _reference(arch, dtype):
    """(ref cfg, numpy params, batch, (loss, metrics), grads) under jit."""
    key = (arch, dtype)
    if key not in _REF:
        rcfg = dataclasses.replace(RC.ARCHS[arch].smoke(), dtype=dtype)
        rapi = ref_build(rcfg)
        pn = jax.tree.map(np.asarray, RS.materialize(rapi.param_specs, jax.random.PRNGKey(0)))
        batch = _batch()
        vg = jax.jit(jax.value_and_grad(rapi.loss_fn, has_aux=True))
        out, grads = vg(pn, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF[key] = (rcfg, pn, batch, out, jax.tree.map(np.asarray, grads))
    return _REF[key]


_PORT = {}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "starcoder2-3b"])
def test_loss_and_gradients_match_jax_value_and_grad(arch, dtype, remat):
    rcfg, pn, batch, (rloss, rm), rgrads = _reference(arch, dtype)
    tcfg = dataclasses.replace(TC.ARCHS[arch].smoke(), dtype=dtype, remat=remat)
    api = build_model(tcfg)
    params = params_from_numpy(pn, "cpu")
    (loss, m), grads = value_and_grad(api.loss_fn, params,
                                      {k: torch.from_numpy(v) for k, v in batch.items()})
    # the caller's tensors are untouched: no flag, no .grad
    assert all(not p.requires_grad and p.grad is None for p in _flat(params).values())
    tol = F32 if dtype == "float32" else BF16_MODEL
    assert int(m["ntok"]) == int(rm["ntok"]) == 2 * SEQ - 3
    assert rel(loss, rloss) <= tol and rel(m["ce"], rm["ce"]) <= tol
    fg, fr = _flat(grads), _flat(rgrads)
    f32 = _flat(_reference(arch, "float32")[4])
    assert sorted(fg) == sorted(fr)
    for k in fg:
        assert fg[k].dtype == params_from_numpy({"x": fr[k]}, "cpu")["x"].dtype, k
        assert torch.isfinite(fg[k].float()).all(), k
        if dtype == "float32":
            gtol = F32_GRAD
        else:
            own = rel(torch.from_numpy(np.array(fr[k], np.float32)), f32[k])
            gtol = max(BF16_MODEL, 0.5 * own)
        assert rel(fg[k], fr[k]) <= gtol, (k, rel(fg[k], fr[k]), gtol)
    _PORT[(arch, dtype, remat)] = grads
    if dtype == "float32" and remat != "none" and (arch, dtype, "none") in _PORT:
        base = _flat(_PORT[(arch, dtype, "none")])
        for k in fg:
            assert rel(fg[k], base[k].float().numpy()) <= REMAT, k


def _ulps(port: torch.Tensor, ref) -> int:
    """The largest distance in bf16 units in the last place."""
    def ordered(bits):
        b = bits.astype(np.int32)
        return np.where(b < 0, -(b & 0x7FFF), b)

    return int(np.abs(ordered(port.view(torch.int16).numpy())
                      - ordered(np.asarray(ref).view(np.int16))).max())


def test_train_cell_with_grad_accum_matches_reference():
    """``build_cell``'s train step, 2 micro-batches of 2 rows, float32
    activations, against the reference's jitted cell: the loss, ``lr`` and
    ``gnorm``; the parameters after the AdamW step (bf16 leaves at most one
    unit in the last place apart, float32 leaves to ``F32_GRAD``: the first
    step moves a leaf by lr g / (|g| + eps), which is as exact as g is); the
    first moments to ``F32_GRAD`` and the second (squared gradients) to
    twice it."""
    from repro.launch.steps import opt_config_for as ref_opt_config_for
    from repro.optim import opt_init as ref_opt_init

    from repro_torch.launch.steps import opt_config_for
    from repro_torch.optim import opt_init

    arch = "starcoder2-3b"
    rcfg = dataclasses.replace(RC.ARCHS[arch].smoke(), dtype="float32", grad_accum=2)
    tcfg = dataclasses.replace(TC.ARCHS[arch].smoke(), dtype="float32", grad_accum=2)
    shape = ("t", 48, 4, "train")
    rcell = ref_build_cell(rcfg, RC.ShapeConfig(*shape))
    tcell = build_cell(tcfg, TC.ShapeConfig(*shape))
    assert tcell.donate == rcell.donate == (0, 1)
    assert sorted(_flat(tcell.arg_specs[1])) == sorted(_flat(rcell.arg_specs[1]))
    pn = jax.tree.map(np.asarray, RS.materialize(rcell.api.param_specs, jax.random.PRNGKey(1)))
    batch = _batch(4, 48, seed=3)
    rp, rs, rmet = jax.jit(rcell.step_fn)(pn, ref_opt_init(ref_opt_config_for(rcfg), pn),
                                          {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(pn, "cpu")
    ts = opt_init(opt_config_for(tcfg), tp)
    out_p, out_s, tmet = tcell.step_fn(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out_p is tp and out_s is ts  # written in place
    assert rel(tmet["loss"], rmet["loss"]) <= F32 and rel(tmet["lr"], rmet["lr"]) <= F32
    assert rel(tmet["gnorm"], rmet["gnorm"]) <= F32_GRAD
    rflat = _flat(jax.tree.map(np.asarray, rp))
    for k, v in _flat(tp).items():
        if v.dtype == torch.bfloat16:
            assert _ulps(v, rflat[k]) <= 1, k
        else:
            assert rel(v, rflat[k]) <= F32_GRAD, k
    rmu = _flat(jax.tree.map(np.asarray, rs["mu"]))
    for k, v in _flat(ts["mu"]).items():
        assert rel(v, rmu[k]) <= (F32_GRAD if k.endswith("/m") else 2 * F32_GRAD), k
    assert int(ts["step"]) == int(rs["step"]) == 1


def test_prefill_and_decode_cells_mirror_reference():
    """``build_cell``'s prefill and decode cells: the reference's argument
    trees and donations, steps that are the model's ``prefill_fn`` and
    ``decode_fn`` (the decode step writes its cache in place)."""
    from repro_torch.runtime.sharding import _map_leaves, materialize

    tcfg, rcfg = TC.ARCHS["gemma2-2b"].smoke(), RC.ARCHS["gemma2-2b"].smoke()
    params = materialize(build_model(tcfg).param_specs, 0, "cpu")
    toks = torch.from_numpy(_batch(2, 16)["tokens"])
    for kind, donate in (("prefill", ()), ("decode", (1,))):
        shape = ("c", 16, 2, kind)
        tcell = build_cell(tcfg, TC.ShapeConfig(*shape))
        rcell = ref_build_cell(rcfg, RC.ShapeConfig(*shape))
        assert tcell.donate == rcell.donate == donate
        assert [sorted(_flat(t)) for t in tcell.arg_specs] == \
            [sorted(_flat(t)) for t in rcell.arg_specs]
        with torch.inference_mode():
            if kind == "prefill":
                got = tcell.step_fn(params, {"tokens": toks})
                assert torch.equal(got, tcell.api.prefill_fn(params, {"tokens": toks}))
            else:
                cache = _map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=ps.dtype),
                                    {k: v for k, v in tcell.arg_specs[1].items() if k != "len"})
                cache["len"] = 0
                logits, new = tcell.step_fn(params, cache, {"tokens": toks[:, :1]})
                assert logits.shape == (2, 1, tcfg.vocab_size) and new["len"] == 1
                assert new["l0"]["k"] is cache["l0"]["k"] and cache["l0"]["k"].abs().sum() > 0


def test_decoder_lm_trains_only_when_asked():
    """``DecoderLM`` keeps serving's default (no gradients); with
    ``requires_grad=True`` a backward reaches every stacked leaf through
    the unit views, equal to ``value_and_grad``'s gradients."""
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.runtime.sharding import materialize

    cfg = dataclasses.replace(TC.ARCHS["starcoder2-3b"].smoke(), dtype="float32")
    api = build_model(cfg)
    params = materialize(api.param_specs, 0, "cpu")
    assert not any(p.requires_grad for p in DecoderLM(cfg, params).parameters())
    lm = DecoderLM(cfg, {k: v for k, v in params.items()}, requires_grad=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 24).items()}
    loss, _ = api.loss_fn(lm.tree(), batch)
    loss.backward()
    _, grads = value_and_grad(api.loss_fn, params, batch)
    for name, p in lm.named_parameters():
        g = _flat(grads)["/" + name.replace(".", "/")]
        assert p.grad is not None and torch.equal(p.grad, g), name
