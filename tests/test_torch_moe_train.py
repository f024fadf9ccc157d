"""Gradients through repro_torch's MoE family — the dense dispatch
(``models.layers.apply_moe``: the router's softmax, the renormalised gates,
the ``index_add_`` into the (E, C + 1, d) bins with the overflow row, the
expert GEMMs, the gather and the gate product), the Switch aux loss
through ``AUX_WEIGHT``, kimi-k2's unstacked dense prefix and its shared
expert — held against ``jax.value_and_grad`` of repro's (JAX on the CPU).

Both packages get the same numpy weights (``draw``: matrices at std
1/sqrt(fan-in), the float32 router at 1/sqrt(d), every norm scale at
random) and tokens.  The reference runs jitted with remat ``"none"`` (its
gradients are the same function under any remat); the port under
``"none"`` and ``"full"``, where ``torch.utils.checkpoint`` recomputes each
unit in the backward and its routes must equal the forward's.

Tolerances (tests/test_torch_train.py's): the loss, ce and aux ``F32`` =
1e-5 in float32; each gradient leaf ``F32_GRAD`` = 2e-3 (bf16 matrices:
their gradients are float32 gradients rounded to bf16).  In bf16 the
routes must agree on ``ROUTE_AGREE`` of the (token, layer) pairs and the
gradients are held up to the first differing route, as
tests/test_torch_moe.py holds bf16 logits: the labels from that token on
are masked, so the loss reads only tokens whose outputs both packages
compute through the same routes (attention is causal, a route's bin slot
counts only earlier routes, and a dropped route contributes zero); each
leaf within ``BF16_MODEL`` = 5e-2 or half the reference's own bf16 error
on that leaf (against its float32 gradient), whichever is larger, as
tests/test_torch_train.py holds the dense family's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
import repro.models.layers as RL
from repro.models import build_model as ref_build
from repro.runtime import sharding as RS

import repro_torch.configs as TC
import repro_torch.models.layers as TL
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import num_units
from repro_torch.runtime import sharding as TS

from test_torch_moe import _ref_routing, _route_diff, ref_routes

F32, F32_GRAD, BF16_MODEL = 1e-5, 2e-3, 5e-2
ROUTE_AGREE = 0.9
MOE = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
SEQ = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    a = port.detach().double().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    b = np.asarray(ref).astype(np.float64)
    return float(np.linalg.norm(a.astype(np.float64) - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def draw(specs, seed=0):
    """A numpy tree for ``specs``: bf16 matrices at std 1/sqrt(fan-in) (the
    second-to-last dim), the float32 router at 1/sqrt(d), the embedding at
    std 1, norm scales in [0.5, 1.5) and biases at std 0.1."""
    rng = np.random.default_rng(seed)

    def one(path, ps):
        name, shape = path[-1], ps.shape
        if name == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            a = rng.normal(0.0, 0.1, shape)
        elif name == "embed":
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return np.asarray(jnp.asarray(a, ps.dtype))

    return RS._map_leaves(one, specs)


def _batch(seed=0, n=2, seq=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (n, seq + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


_WEIGHTS, _REF = {}, {}


def weights(arch):
    if arch not in _WEIGHTS:
        _WEIGHTS[arch] = draw(ref_build(RC.ARCHS[arch].smoke()).param_specs)
    return _WEIGHTS[arch]


def reference(arch, dtype, labels=None):
    """The reference's ((loss, metrics), grads, routes) on ``_batch()``
    (``labels`` in its place if given), jitted once per (arch, dtype)."""
    key = (arch, dtype)
    if key not in _REF:
        rcfg = dataclasses.replace(RC.ARCHS[arch].smoke(), dtype=dtype, remat="none")
        _REF[key] = jax.jit(jax.value_and_grad(ref_build(rcfg).loss_fn, has_aux=True))
    batch = _batch()
    if labels is not None:
        batch["labels"] = labels
    with ref_routes() as rr:
        (loss, m), g = _REF[key](weights(arch), jax.tree.map(jnp.asarray, batch))
        loss = np.asarray(loss)
    return (loss, m), _flat(jax.tree.map(np.asarray, g)), list(rr)


def port(arch, dtype, remat, labels=None):
    """The port's ((loss, metrics), grads, forward routes, recompute routes)."""
    cfg = dataclasses.replace(TC.ARCHS[arch].smoke(), dtype=dtype, remat=remat)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    if labels is not None:
        batch["labels"] = torch.from_numpy(labels)
    params = params_from_numpy(weights(arch), "cpu")
    with TL.recording_routes() as tr:
        out, grads = value_and_grad(build_model(cfg).loss_fn, params, batch)
    U = num_units(cfg)
    return out, _flat(grads), tr[:U], tr[U:]


def _same_routes(a, b) -> bool:
    return all(torch.equal(x.experts, y.experts) and torch.equal(x.kept, y.kept)
               for x, y in zip(a, b))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_gradients_match_jax_value_and_grad(arch, dtype, remat):
    """``loss_fn``'s value (ce, aux, ce + 0.01 aux) and every gradient leaf
    — the router, the stacked experts, attention, norms, the embedding,
    kimi-k2's dense prefix and shared expert — against the reference's,
    with routes dropped (C = int(T K 1.25 / E)); under ``"full"`` the
    recompute's routes equal the forward's."""
    (rloss, rm), rgrads, rr = reference(arch, dtype)
    (loss, m), grads, fwd, again = port(arch, dtype, remat)
    U = len(fwd)
    assert len(rr) >= U and U == num_units(TC.ARCHS[arch].smoke())
    if remat == "full":
        assert len(again) == U and _same_routes(fwd, again[::-1])
    else:
        assert not again
    assert sum(int((~r.kept).sum()) for r in fwd) > 0  # the overflow row is used
    bad, first, agree = _route_diff(rr[:U], fwd)
    assert sorted(grads) == sorted(rgrads)
    assert int(m["ntok"]) == int(rm["ntok"])
    assert "/blocks/l0/moe/router" in grads
    if arch == "kimi-k2-1t-a32b":
        assert "/prefix/p0/mlp/w_gate" in grads and "/blocks/l0/moe/shared/w_in" in grads
    if dtype == "float32":
        assert not bad.any()
        for got, want in ((loss, rloss), (m["ce"], rm["ce"]), (m["aux"], rm["aux"])):
            assert rel(got, want) <= F32
        for k, g in grads.items():
            assert torch.isfinite(g.float()).all(), k
            assert rel(g, rgrads[k]) <= F32_GRAD, (k, rel(g, rgrads[k]))
        return
    assert agree >= ROUTE_AGREE, agree
    assert rel(m["aux"], rm["aux"]) <= BF16_MODEL
    if bad.any():
        # hold the gradients up to the first differing route: mask the
        # labels from that (batch, position) on, in both packages
        labels = _batch()["labels"].copy()
        labels.reshape(-1)[first:] = -1
        (rloss, rm), rgrads, rr = reference(arch, dtype, labels)
        (loss, m), grads, fwd, _ = port(arch, dtype, remat, labels)
        assert not _route_diff(rr[:U], fwd)[0][:first].any()
    assert rel(loss, rloss) <= BF16_MODEL and rel(m["ce"], rm["ce"]) <= BF16_MODEL
    f32 = reference(arch, "float32", None if not bad.any() else labels)[1]
    for k, g in grads.items():
        assert torch.isfinite(g.float()).all(), k
        own = rel(torch.from_numpy(np.array(rgrads[k], np.float32)), f32[k])
        gtol = max(BF16_MODEL, 0.5 * own)
        assert rel(g, rgrads[k]) <= gtol, (k, rel(g, rgrads[k]), gtol)


def _moe_layer_case(dtype, cf, shared):
    kw = dict(mlp_act="swiglu", shared_experts=shared, capacity_factor=cf, experts_per_tok=3)
    rcfg = dataclasses.replace(RC.ARCHS["qwen3-moe-30b-a3b"].smoke(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(TC.ARCHS["qwen3-moe-30b-a3b"].smoke(), dtype=dtype, **kw)
    p = draw({"moe": RL.moe_specs(rcfg)}, seed=5)["moe"]
    rng = np.random.default_rng(5)
    act = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 9, rcfg.d_model)) * 2, act))
    g = rng.standard_normal((2, 9, rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, p, x, g


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cf,shared", [(1.25, 1), (0.25, 0)], ids=["drops-shared", "C1"])
def test_apply_moe_gradients(cf, shared, dtype):
    """The layer alone: d/d(x, router, experts, shared expert) of
    sum(out * g) + aux against ``jax.grad`` of ``_apply_moe_dense``, with
    the same routes; at capacity factor 0.25 (C = 1) most routes drop, and
    through the outputs a token whose every route dropped (no shared
    expert) gets exactly zero gradient: a dropped route contributes
    nothing, the overflow row included."""
    rcfg, tcfg, p, x, g = _moe_layer_case(dtype, cf, shared)

    def ref_loss(p, x):
        out, aux = RL._apply_moe_dense(p, x, rcfg)
        return jnp.sum(out.astype(jnp.float32) * g) + aux

    rg_p, rg_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(p, jnp.asarray(x))
    tree = TS._map_leaves(lambda _, t: t.requires_grad_(True), params_from_numpy(p, "cpu"))
    tx = params_from_numpy({"x": x}, "cpu")["x"].requires_grad_(True)
    with TL.recording_routes() as routes:
        out, aux = TL.apply_moe(tree, tx, tcfg)
    part = (out.float() * torch.from_numpy(g)).sum()
    (gx_out,) = torch.autograd.grad(part, tx, retain_graph=True)
    part.add(aux).backward()
    re, rk, _ = (np.asarray(a) for a in _ref_routing(p, jnp.asarray(x), rcfg))
    (r,) = routes
    assert np.array_equal(r.experts.numpy(), re) and np.array_equal(r.kept.numpy(), rk)
    tol = F32_GRAD if dtype == "float32" else BF16_MODEL
    rflat, tflat = _flat(jax.tree.map(np.asarray, rg_p)), _flat(tree)
    assert sorted(tflat) == sorted(rflat)
    for k, v in tflat.items():
        assert rel(v.grad, rflat[k]) <= tol, (k, rel(v.grad, rflat[k]))
    assert rel(tx.grad, rg_x) <= tol
    assert float(tree["router"].grad.abs().sum()) > 0
    if cf == 0.25:
        # through the outputs alone (the aux reads every token's router
        # probabilities), a token whose every route dropped gets nothing
        gone = torch.from_numpy(~rk.any(1))
        assert int(gone.sum()) >= 3
        assert not gx_out.reshape(18, -1)[gone].any()
        assert gx_out.reshape(18, -1)[~gone].abs().sum(1).min() > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_gradient_where_exp_overflows(dtype):
    """SiLU's gradient is the logistic's own, as ``jax.nn.silu``'s is: 0, not
    NaN, where ``exp(-x)`` overflows (x < -88: the smoke models' MoE bins
    reach that, the overflow row's sums first)."""
    xs = np.array([-400.0, -100.0, -89.0, -88.0, -20.0, -1.0, 0.0, 0.5, 3.0, 90.0], np.float32)
    x = np.asarray(jnp.asarray(xs, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    want = jax.vmap(jax.grad(jax.nn.silu))(jnp.asarray(x))
    tx = params_from_numpy({"x": x}, "cpu")["x"].requires_grad_(True)
    y = TL._silu(tx)
    (g,) = torch.autograd.grad(y.sum(), tx)
    assert torch.isfinite(g.float()).all()
    assert rel(y, jax.nn.silu(jnp.asarray(x))) <= F32
    assert rel(g, want) <= (F32 if dtype == "float32" else BF16_MODEL)
    assert g[:3].float().abs().max() == 0


@pytest.mark.parametrize("arch", MOE)
def test_smoke_trains_with_finite_gradients(arch):
    """``launch.train.train`` on the smoke config (the port's draw, remat
    ``"full"``): every loss and gradient norm finite."""
    from repro_torch.launch.train import train

    out = train(arch, steps=2, device="cpu", log_every=0)
    assert len(out["history"]) == 2
    assert all(np.isfinite([h["loss"], h["gnorm"]]).all() for h in out["history"])


def test_train_cli_cuts_depth_and_shape(capsys):
    """``launch.train``'s ``--layers`` cuts the depth and ``--batch`` /
    ``--seq`` the shape (the card runs use them on the published widths)."""
    from repro_torch.launch.train import main, train

    out = train("qwen3-moe-30b-a3b", steps=1, layers=1, device="cpu", log_every=0)
    assert out["config"].num_layers == 1 and out["config"].num_experts == 8
    assert len(out["state"]["params"]["blocks"]["l0"]["moe"]["router"]) == 1
    assert main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--layers", "1", "--steps", "1",
                 "--batch", "1", "--seq", "16", "--device", "cpu"]) == 0
    assert "final loss" in capsys.readouterr().out
