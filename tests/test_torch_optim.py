"""repro_torch.optim held against repro.optim (JAX on the CPU).

Both packages get the same numpy parameters and gradients: a tree with a
bf16 matrix, a bf16 stacked (U, d, n) leaf, a float32 vector (a norm scale)
and a float32 scalar, stepped three times (the first step's gradients are
clipped, the next two are not).  The reference's update runs under
``jax.jit``, as its train step does.  Tolerances, leaf for leaf:

* float32 leaves (parameters, AdamW/Adafactor moments, int8 scales, the
  schedule, the global norm and the clip factor): relative error
  max|port - ref| / max|ref| <= ``F32`` = 1e-6 (libm ulps in ``cos``,
  ``pow`` and summation order are all that differ);
* bf16 leaves: at most ``BF16_ULP`` = 1 unit in the last place apart;
* int8 codes: equal, except where the float32 value sits on a rounding
  boundary, where they differ by 1; at most ``INT8_FLIPS`` = 1% of the codes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.optim as RO
from repro.runtime.sharding import ParamSpec as RParamSpec

import repro_torch.optim as TO
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.sharding import ParamSpec

F32, BF16_ULP, INT8_FLIPS = 1e-6, 1, 0.01
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    bf = jnp.bfloat16
    return {
        "w": rng.standard_normal((8, 16)).astype(bf),
        "blocks": {"wq": rng.standard_normal((3, 8, 16)).astype(bf)},
        "ln": {"scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)},
        "s": np.asarray(0.5, np.float32),
    }


def _grads(params, step, seed=1):
    rng = np.random.default_rng([seed, step])
    scale = 1.0 if step == 0 else 0.01  # step 1: clipped; steps 2, 3: not
    return {k: _grads(v, step, seed) if isinstance(v, dict)
            else (scale * rng.standard_normal(np.shape(v))).astype(v.dtype)
            for k, v in params.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _ordered(bits):
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _check_leaf(name, port, ref, flips):
    ref = np.asarray(ref)
    if port.dtype == torch.bfloat16:
        assert ref.dtype.name == "bfloat16", name
        d = np.abs(_ordered(port.view(torch.int16).numpy()) - _ordered(ref.view(np.int16)))
        assert d.max(initial=0) <= BF16_ULP, (name, d.max())
    elif port.dtype == torch.int8:
        d = port.numpy().astype(np.int32) - ref.astype(np.int32)
        assert np.abs(d).max(initial=0) <= 1, name
        flips.append((int(np.count_nonzero(d)), d.size))
    else:
        a, b = port.double().numpy(), ref.astype(np.float64)
        assert a.shape == b.shape and str(port.dtype).split(".")[1] == ref.dtype.name, name
        err = np.abs(a - b).max(initial=0) / max(np.abs(b).max(initial=0), 1e-30)
        assert err <= F32, (name, err)


def _check_tree(port, ref, flips):
    fp, fr = _flat(port), _flat(ref)
    assert sorted(fp) == sorted(fr)
    for k in fp:
        _check_leaf(k, fp[k], fr[k], flips)


CONFIGS = {
    "adamw_float32": dict(name="adamw", state_dtype="float32"),
    "adamw_bfloat16": dict(name="adamw", state_dtype="bfloat16"),
    "adamw_int8": dict(name="adamw", state_dtype="int8"),
    "adafactor": dict(name="adafactor"),
}


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_opt_update_matches_reference_over_three_steps(which):
    kw = dict(CONFIGS[which], lr=0.1, warmup_steps=2, total_steps=10)
    rcfg, tcfg = RO.OptConfig(**kw), TO.OptConfig(**kw)
    pn = _params()
    rparams = jax.tree.map(jnp.asarray, pn)
    tparams = params_from_numpy(pn, "cpu")
    rstate, tstate = RO.opt_init(rcfg, rparams), TO.opt_init(tcfg, tparams)
    flips = []
    _check_tree(tstate, jax.tree.map(np.asarray, rstate), flips)
    rupdate = jax.jit(lambda g, s, p: RO.opt_update(rcfg, g, s, p))
    for step in range(STEPS):
        gn = _grads(pn, step)
        rparams, rstate, rm = rupdate(jax.tree.map(jnp.asarray, gn), rstate, rparams)
        ids = [id(x) for x in _flat(tparams).values()]
        out_p, out_s, tm = TO.opt_update(tcfg, params_from_numpy(gn, "cpu"), tstate, tparams)
        # written in place: the same tensors come back
        assert out_p is tparams and out_s is tstate
        assert [id(x) for x in _flat(out_p).values()] == ids
        _check_tree(tparams, jax.tree.map(np.asarray, rparams), flips)
        _check_tree(tstate, jax.tree.map(np.asarray, rstate), flips)
        for k in ("lr", "gnorm"):
            _check_leaf(k, tm[k], rm[k], flips)
        assert int(tstate["step"]) == step + 1 and tstate["step"].dtype == torch.int32
    changed, total = sum(f for f, _ in flips), sum(n for _, n in flips)
    assert changed <= INT8_FLIPS * max(total, 1), (changed, total)


def test_schedule_norm_and_clip_match_reference():
    flips = []
    for name in ("adamw", "adafactor"):
        kw = dict(name=name, lr=3e-4, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
        rcfg, tcfg = RO.OptConfig(**kw), TO.OptConfig(**kw)
        for step in (0, 1, 3, 5, 6, 17, 39, 40, 55):
            _check_leaf(f"schedule {step}",
                        TO.schedule(tcfg, torch.tensor(step, dtype=torch.int32)),
                        RO.schedule(rcfg, jnp.asarray(step, jnp.int32)), flips)
    for scale in (1.0, 1e-3):
        gn = jax.tree.map(lambda a: (scale * a.astype(np.float32)).astype(a.dtype),
                          _grads(_params(), 0))
        tg, rg = params_from_numpy(gn, "cpu"), jax.tree.map(jnp.asarray, gn)
        _check_leaf("global_norm", TO.global_norm(tg), RO.global_norm(rg), flips)
        for max_norm in (1.0, 0.5):
            ts, tn = TO.optimizers.clip_scale(tg, max_norm)
            rs, rn = RO.optimizers.clip_scale(rg, max_norm)
            _check_leaf("clip_scale", ts, rs, flips)
            _check_leaf("norm", tn, rn, flips)
            tc, _ = TO.clip_by_global_norm(tg, max_norm)
            rc, _ = RO.clip_by_global_norm(rg, max_norm)
            _check_tree(tc, jax.tree.map(np.asarray, rc), flips)


@pytest.mark.parametrize("which", sorted(CONFIGS))
def test_opt_state_specs_mirror_reference(which):
    rcfg, tcfg = RO.OptConfig(**CONFIGS[which]), TO.OptConfig(**CONFIGS[which])
    tspecs = {"w": ParamSpec((8, 16), ("fsdp", "ffn")),
              "ln": {"scale": ParamSpec((16,), (None,), torch.float32, "ones")}}
    rspecs = {"w": RParamSpec((8, 16), ("fsdp", "ffn")),
              "ln": {"scale": RParamSpec((16,), (None,), jnp.float32, "ones")}}
    tout, rout = _flat(TO.opt_state_specs(tcfg, tspecs)), _flat(RO.opt_state_specs(rcfg, rspecs))
    assert sorted(tout) == sorted(rout)
    for k in tout:
        assert tout[k].shape == rout[k].shape and tout[k].logical == rout[k].logical, k
        assert str(tout[k].dtype).split(".")[1] == jnp.dtype(rout[k].dtype).name, k


def test_quantize_ef_and_compress_tree_match_reference():
    rng = np.random.default_rng(5)
    flips = []
    for shape in ((64, 32), (7,), ()):
        g = np.asarray(rng.standard_normal(shape), np.float32)
        ef = np.asarray(0.01 * rng.standard_normal(shape), np.float32)
        tq, ts, te = TO.quantize_ef(torch.from_numpy(g), torch.from_numpy(ef))
        rq, rs, re_ = RO.quantize_ef(jnp.asarray(g), jnp.asarray(ef))
        _check_leaf("q", tq, rq, flips)
        _check_leaf("scale", ts, rs, flips)
        _check_leaf("ef", te, re_, flips)
        _check_leaf("deq", TO.dequantize(tq, ts), RO.dequantize(rq, rs), flips)
    gn = _grads(_params(), 0)
    rg = jax.tree.map(jnp.asarray, gn)
    tg = params_from_numpy(gn, "cpu")
    te, re_ = TO.init_ef(tg), RO.init_ef(rg)
    _check_tree(te, jax.tree.map(np.asarray, re_), flips)
    for _ in range(2):  # the second round carries the first's error feedback
        tg_out, te = TO.compress_tree(tg, te)
        rg_out, re_ = RO.compress_tree(rg, re_)
        _check_tree(tg_out, jax.tree.map(np.asarray, rg_out), flips)
        _check_tree(te, jax.tree.map(np.asarray, re_), flips)
    changed, total = sum(f for f, _ in flips), sum(n for _, n in flips)
    assert changed <= INT8_FLIPS * max(total, 1), (changed, total)


def test_adamw_update_keeps_leaf_dtypes_and_devices():
    cfg = TO.OptConfig(lr=0.1, warmup_steps=1, state_dtype="int8")
    p = params_from_numpy(_params(), "cpu")
    state = TO.opt_init(cfg, p)
    assert state["mu"]["w"]["ms"].shape == (8, 1) and state["mu"]["s"]["ms"].shape == ()
    before = {k: v.clone() for k, v in _flat(p).items()}
    TO.opt_update(cfg, params_from_numpy(_grads(_params(), 0), "cpu"), state, p)
    for k, v in _flat(p).items():
        assert v.dtype == before[k].dtype and not torch.equal(v, before[k]), k
