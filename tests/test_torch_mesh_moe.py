"""repro_torch's MoE mesh dispatches (``models.layers._apply_moe_ep_a2a`` and
``_apply_moe_shardmap``, ``local_map`` islands over a (2, 2, 2) ("pod",
"data", "model") mesh of 8 CPU gloo ranks) held against repro's jitted
``apply_moe`` under a (2, 2, 2) mesh of 8 host devices.

The reference runs in one subprocess for the file (its 8 host devices set
in that subprocess's environment only) and the port in 8 spawned ranks, so
no process group and no device count leaks into the pytest process.  Both
get the same numpy weights (drawn here at std 1/sqrt(fan-in), bf16 values
carried as float32; the router float32) and inputs, and run side by side.
Cases: both islands, shared
experts 0 and 1, a capacity factor with no drops (16) and the published
1.25 (drops).  ``out`` and ``aux`` are held to the reference test's own
tolerances (tests/test_moe_shardmap.py: 2e-4 / 2e-5 for the shardmap
island, 3e-4 / 3e-5 for the a2a island, aux 1e-4), the kept/dropped masks
of every shard to equality, and the gradients of ``sum(out^2) + 0.5 aux``
to ``jax.grad``'s: the input's within 1e-4 relative L2, the bf16 weights'
within ``GRAD_TOL`` (their own rounding, ~4e-3).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
CASES = [(island, shared, cf) for island in ("shardmap", "ep_a2a") for shared in (0, 1)
         for cf in (16.0, 1.25)]
IDS = [f"{i}-shared{s}-cf{c}" for i, s, c in CASES]
TOL = {"shardmap": (2e-4, 2e-5), "ep_a2a": (3e-4, 3e-5)}
GRAD_TOL = 1e-2
X_SHAPE = (4, 16)

REF = textwrap.dedent('''
    import dataclasses, pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from repro.configs import ARCHS
    from repro.models.layers import apply_moe, _local_positions
    from repro.runtime.sharding import axis_rules

    cases = pickle.loads(bytes.fromhex(sys.argv[2]))
    with open(sys.argv[3], "rb") as f:
        weights, inputs = pickle.load(f)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
    out = {}
    for island, shared, cf in cases:
        cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"].smoke(), num_experts=8,
                                  experts_per_tok=2, expert_d_ff=64, capacity_factor=cf,
                                  shared_experts=shared, dtype="float32")
        def tree(t, name=""):
            if isinstance(t, dict):
                return {k: tree(v, k) for k, v in t.items()}
            return jnp.asarray(t, jnp.float32 if name == "router" else jnp.bfloat16)

        p = tree(weights[shared])
        x = jnp.asarray(inputs, jnp.float32)
        rules = {"residual_seq": "model"} if island == "ep_a2a" else None

        def loss(p, x):
            o, a = apply_moe(p, x, cfg)
            return jnp.sum(jnp.square(o)) + 0.5 * a

        with mesh, axis_rules(mesh, rules):
            o, a = jax.jit(lambda p, x: apply_moe(p, x, cfg))(p, x)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        # each shard's routing, with the reference's own top_k and positions
        masks = {}
        E, K = cfg.num_experts, cfg.experts_per_tok
        for b in range(4):
            for m in range(2 if island == "ep_a2a" else 1):
                xl = x[b:b + 1] if island == "shardmap" else x[b:b + 1, 8 * m:8 * m + 8]
                xt = xl.reshape(-1, cfg.d_model)
                T = xt.shape[0]
                probs = jax.nn.softmax(xt @ p["router"], axis=-1)
                _, ids = lax.top_k(probs, K)
                pos = _local_positions(ids.reshape(T * K).astype(jnp.int32), E)
                C = max(1, int(T * K * cf / E))
                masks[(b // 2, b % 2, m)] = np.asarray(pos < C).reshape(T, K)
        f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        out[(island, shared, cf)] = dict(out=np.asarray(o), aux=float(a), gp=f32(gp),
                                         gx=np.asarray(gx), masks=masks)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
''')


def _param(name, a):
    t = torch.from_numpy(np.asarray(a))
    return (t if name == "router" else t.to(torch.bfloat16)).requires_grad_(True)


def _flat(tree):
    """Leaves in sorted-key order (a JAX pytree's)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


def _weights():
    """Each shared-expert count's weights (numpy float32 holding bf16 values;
    the router float32, std 1/sqrt(fan-in)) and the input."""
    rng = np.random.default_rng(0)
    d, E, ff = 128, 8, 64

    def w(shape, fan):
        a = rng.standard_normal(shape).astype(np.float32) / np.sqrt(fan)
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    out = {}
    for shared in (0, 1):
        p = {"router": (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32),
             "w_gate": w((E, d, ff), d), "w_in": w((E, d, ff), d), "w_out": w((E, ff, d), ff)}
        if shared:
            p["shared"] = {"w_gate": w((d, ff), d), "w_in": w((d, ff), d), "w_out": w((ff, d), ff)}
        out[shared] = p
    x = (rng.standard_normal(X_SHAPE + (d,)) * 0.1).astype(np.float32)
    return out, x


def _port_rank(rank, world, port, ref_path, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.configs import ARCHS
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import layers as L
        from repro_torch.runtime.sharding import axis_rules, full_tree

        with open(ref_path, "rb") as f:
            weights, inputs = pickle.load(f)
        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        res = {}
        for island, shared, cf in CASES:
            cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"].smoke(), num_experts=8,
                                      experts_per_tok=2, expert_d_ff=64, capacity_factor=cf,
                                      shared_experts=shared, dtype="float32")

            # the reference's bf16 weights come as float32 (exact); its router
            # is float32
            p = {k: ({kk: _param(kk, vv) for kk, vv in v.items()} if isinstance(v, dict)
                     else _param(k, v)) for k, v in weights[shared].items()}
            x = torch.from_numpy(inputs).requires_grad_(True)
            rules = {"residual_seq": "model"} if island == "ep_a2a" else None
            with axis_rules(mesh, rules), L.recording_routes() as routes:
                o, a = L.apply_moe(p, x, cfg)
                loss = (o.float() ** 2).sum() + 0.5 * a
                grads = torch.autograd.grad(loss.full_tensor(), [x] + _flat(p))
            routed = {tuple(rt.shard[k] for k in ("pod", "data")) + (
                rt.shard["model"] if island == "ep_a2a" else 0,): (rt.route, rt.kept.numpy())
                for rt in routes}
            gathered = [None] * world
            dist.all_gather_object(gathered, routed)
            res[(island, shared, cf)] = dict(
                out=o.full_tensor().detach().numpy(), aux=float(full_tree(a)),
                gx=grads[0].numpy(), gp=[g.float().numpy() for g in grads[1:]],
                masks={k: v for d in gathered for k, v in d.items()})
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import socket

    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_moe")
    w_path, ref_path, out_path = tmp / "weights.pkl", tmp / "ref.pkl", tmp / "port.pkl"
    with open(w_path, "wb") as f:
        pickle.dump(_weights(), f)
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    # the reference and the port side by side
    ref_proc = subprocess.Popen([sys.executable, "-c", REF, str(ref_path),
                                 pickle.dumps(CASES).hex(), str(w_path)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.spawn(_port_rank, args=(8, port, str(w_path), str(out_path)), nprocs=8)
    finally:
        _, err = ref_proc.communicate(timeout=300)
    assert ref_proc.returncode == 0, err[-3000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    return ref, got


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_out_and_aux_match(runs, case):
    ref, got = runs[0][case], runs[1][case]
    rtol, atol = TOL[case[0]]
    np.testing.assert_allclose(got["out"], ref["out"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_shard_masks_equal(runs, case):
    ref, got = runs[0][case], runs[1][case]
    assert set(got["masks"]) == set(ref["masks"])
    for key, (route, kept) in got["masks"].items():
        assert route == case[0]
        np.testing.assert_array_equal(kept, ref["masks"][key], err_msg=str(key))
    dropped = sum(int((~m).sum()) for m in ref["masks"].values())
    assert (dropped == 0) == (case[2] == 16.0), dropped


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grads_match_jax_grad(runs, case):
    ref, got = runs[0][case], runs[1][case]
    assert _rel(got["gx"], ref["gx"]) < 1e-4
    ref_leaves = _flat(ref["gp"])
    assert len(got["gp"]) == len(ref_leaves)
    for g, r in zip(got["gp"], ref_leaves):
        assert g.shape == r.shape
        assert _rel(g, r) < GRAD_TOL
