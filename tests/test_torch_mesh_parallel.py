"""repro_torch's GPipe pipeline (``runtime.pipeline.pipelined_apply``) and
int8-payload mean (``optim.compressed_psum``) over a 4-rank ``"pod"`` mesh
of CPU gloo ranks, held against repro's under a 4-device host mesh (in one
subprocess for the file) and against the plain computations.

The pipeline's output must equal the reference's and the sequential
application of the whole layer stack within 1e-5; ``compressed_psum``'s
mean must equal the reference's within 1e-6 (the same int8 codes and
scales, dequantized in the same order) and the true mean within
tests/test_substrate.py's 2e-2, and its error feedback the reference's
within 1e-6 (one float32 rounding of ``x - q * scale``).
"""
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
L, B, D, M = 8, 8, 16, 4
N = 32

REF = textwrap.dedent('''
    import pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.optim.compression import compressed_psum
    from repro.runtime.pipeline import pipelined_apply

    L, B, D, M, N = (int(a) for a in sys.argv[2:7])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("pod",))
    rng = np.random.default_rng(0)
    Ws = jnp.asarray(rng.standard_normal((L, D, D)) * 0.1, jnp.float32)
    x = jnp.asarray(rng.standard_normal((B, D)), jnp.float32)

    def stage_fn(ws, h):
        def body(h, w):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, h, ws)[0]

    y = jax.jit(lambda W, xx: pipelined_apply(stage_fn, W, xx, mesh, axis="pod",
                                              microbatches=M))(Ws, x)
    gs = jnp.asarray(np.random.default_rng(1).standard_normal((4, N)), jnp.float32)
    efs = jnp.asarray(np.random.default_rng(2).standard_normal((4, N)) * 1e-3, jnp.float32)

    def body(g, ef):
        mean, new_ef = compressed_psum(g[0], ef[0], "pod")
        return mean[None], new_ef[None]

    mean, new_ef = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                                     out_specs=(P("pod"), P("pod")), check=False))(gs, efs)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(dict(Ws=np.asarray(Ws), x=np.asarray(x), y=np.asarray(y), gs=np.asarray(gs),
                         efs=np.asarray(efs), mean=np.asarray(mean), new_ef=np.asarray(new_ef)), f)
''')


def _port_rank(rank, world, port, ref_path, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.optim import compressed_psum
        from repro_torch.runtime.pipeline import pipelined_apply
        from repro_torch.runtime.sharding import shard_map

        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        mesh = make_debug_mesh((4,), ("pod",), device="cpu")
        Ws, x = torch.from_numpy(ref["Ws"]), torch.from_numpy(ref["x"])

        def stage_fn(ws, h):
            for w in ws:
                h = torch.tanh(h @ w)
            return h

        y = pipelined_apply(stage_fn, Ws, x, mesh, axis="pod", microbatches=M).full_tensor()
        seq = stage_fn(Ws, x)

        def body(g, ef):
            mean, new_ef = compressed_psum(g[0], ef[0], "pod", mesh)
            return mean[None], new_ef[None]

        spec = ("pod", None)
        mean, new_ef = shard_map(mesh, body, (spec, spec),
                                 (torch.from_numpy(ref["gs"]), torch.from_numpy(ref["efs"])),
                                 in_specs=(spec, spec))
        mean, new_ef = mean.full_tensor(), new_ef.full_tensor()
        # the card's transport for all-gathers, exercised on CPU tensors:
        # every all_gather_into_tensor through pinned-host staging's path
        from repro_torch.runtime import collectives as coll

        staged = []
        real = coll.host_staged
        coll.host_staged = lambda *a, **k: staged.append(1) or real(*a, **k)
        try:
            with coll._HostStaging("cpu"):
                m2, e2 = shard_map(mesh, body, (spec, spec),
                                   (torch.from_numpy(ref["gs"]), torch.from_numpy(ref["efs"])),
                                   in_specs=(spec, spec))
                m2, e2 = m2.full_tensor(), e2.full_tensor()
        finally:
            coll.host_staged = real
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(dict(y=y.numpy(), seq=seq.numpy(), mean=mean.numpy(),
                                 new_ef=new_ef.numpy(), staged_mean=m2.numpy(),
                                 staged_ef=e2.numpy(), staged=len(staged)), f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import socket

    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_parallel")
    ref_path, out_path = tmp / "ref.pkl", tmp / "port.pkl"
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    res = subprocess.run([sys.executable, "-c", REF, str(ref_path), *map(str, (L, B, D, M, N))],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_port_rank, args=(4, port, str(ref_path), str(out_path)), nprocs=4)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    with open(out_path, "rb") as f:
        got = pickle.load(f)
    return ref, got


def test_pipeline_matches_reference_and_sequential(runs):
    ref, got = runs
    np.testing.assert_allclose(got["y"], ref["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["y"], got["seq"], rtol=1e-5, atol=1e-5)


def test_compressed_psum_matches_reference(runs):
    ref, got = runs
    np.testing.assert_allclose(got["mean"], ref["mean"], rtol=1e-6, atol=1e-6)
    # x - q * scale: XLA may fuse it into one rounding, PyTorch rounds twice
    np.testing.assert_allclose(got["new_ef"], ref["new_ef"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["mean"][0], np.mean(ref["gs"], axis=0), atol=2e-2)
    for r in range(4):  # every rank holds the same mean
        np.testing.assert_array_equal(got["mean"][r], got["mean"][0])


def test_host_staged_all_gathers_give_the_same_bits(runs):
    """``collectives.host_staging``'s path (taken on the card for gloo's
    all-gathers), run here on CPU tensors: the same bits, and every
    all-gather of the two gathers and the full_tensor calls went through it."""
    _, got = runs
    assert got["staged"] >= 4
    np.testing.assert_array_equal(got["staged_mean"], got["mean"])
    np.testing.assert_array_equal(got["staged_ef"], got["new_ef"])
