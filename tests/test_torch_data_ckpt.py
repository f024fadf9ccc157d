"""repro_torch.data, repro_torch.checkpoint and elastic_restore held against
repro's (JAX on the CPU).

Every comparison here is exact: the data pipeline is a numpy copy (the same
bits for the same seed, step and shard), and a checkpoint written by either
package restores in the other bit for bit, bf16 leaves included.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.configs as RC
from repro.checkpoint import Checkpointer as RCheckpointer
from repro.data import DataConfig as RDataConfig
from repro.data import TokenPipeline as RTokenPipeline

import repro_torch.configs as TC
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import elastic_restore
from repro_torch.runtime.sharding import materialize


def _pipes(arch, shape, source, path=None, shard=0, num_shards=1):
    r = RTokenPipeline(RDataConfig(source=source, path=path, seed=7), RC.ARCHS[arch].smoke(),
                       RC.ShapeConfig(*shape), shard=shard, num_shards=num_shards)
    t = TokenPipeline(DataConfig(source=source, path=path, seed=7), TC.ARCHS[arch].smoke(),
                      TC.ShapeConfig(*shape), shard=shard, num_shards=num_shards)
    return r, t


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("source", ["synthetic", "markov", "binfile"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_token_pipeline_batches_bit_for_bit(tmp_path, source, shard):
    path = None
    if source == "binfile":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(3).integers(0, 60000, 5000, dtype=np.uint16).tofile(path)
    r, t = _pipes("gemma2-2b", ("t", 33, 5, "train"), source, path, *shard)
    assert t.local_batch == r.local_batch
    for step in (0, 1, 17, 400):
        _same_batch(r.batch_at(step), t.batch_at(step))
    for rb, tb, _ in zip(r, t, range(3)):
        _same_batch(rb, tb)


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-medium", "gemma2-2b"])
def test_with_frontend_bit_for_bit(arch):
    r, t = _pipes(arch, ("t", 64, 2, "train"), "synthetic")
    for step in (0, 5):
        _same_batch(r.with_frontend(r.batch_at(step), step),
                    t.with_frontend(t.batch_at(step), step))


def _tree(seed=0):
    """A train checkpoint's shape: bf16 and float32 params, float32, int8 and
    int32 optimizer leaves, the step as int64."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"embed": rng.standard_normal((16, 8)).astype(jnp.bfloat16),
                   "blocks": {"l0": {"wq": rng.standard_normal((2, 8, 8)).astype(jnp.bfloat16)}},
                   "ln_f": {"scale": rng.standard_normal(8).astype(np.float32)}},
        "opt": {"mu": {"embed": {"m": rng.standard_normal((16, 8)).astype(np.float32),
                                 "mq": rng.integers(-127, 128, (16, 8)).astype(np.int8)}},
                "step": np.asarray(3, np.int32)},
        "meta": {"step": np.asarray(3)},
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _bits(x) -> tuple:
    """(dtype name, shape, raw bytes) of a tensor or a numpy array."""
    if torch.is_tensor(x):
        name = str(x.dtype).split(".")[1]
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        a = x.numpy()
    else:
        a = np.asarray(x)
        name = a.dtype.name
    return name, a.shape, a.tobytes()


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert _bits(fa[k]) == _bits(fb[k]), k


def test_port_checkpoint_restores_in_reference_and_back(tmp_path):
    tree = _tree()
    port_tree = {k: params_from_numpy(v, "cpu") for k, v in tree.items()}
    Checkpointer(str(tmp_path / "port")).save(3, port_tree)
    back = RCheckpointer(str(tmp_path / "port")).restore()
    _same_tree(back, tree)
    RCheckpointer(str(tmp_path / "ref")).save(3, tree)
    ck = Checkpointer(str(tmp_path / "ref"))
    assert ck.latest_step() == 3 and ck.all_steps() == [3]
    _same_tree(ck.restore(device="cpu"), tree)
    # the same bytes on disk, whichever package wrote them
    for name in ("manifest.json", "0.npz"):
        files = [tmp_path / d / "step_00000003" / name for d in ("port", "ref")]
        if name == "manifest.json":
            assert files[0].read_text() == files[1].read_text()
        else:
            ra, rb = np.load(files[0]), np.load(files[1])
            assert sorted(ra.files) == sorted(rb.files)
            for k in ra.files:
                assert ra[k].dtype == rb[k].dtype and np.array_equal(ra[k], rb[k]), k


def test_async_save_copies_before_returning_and_keeps_the_last_three(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    t = {k: params_from_numpy(v, "cpu") for k, v in _tree().items()}
    expect = {k: params_from_numpy(v, "cpu") for k, v in _tree().items()}
    for step in range(1, 6):
        ck.save(step, t, blocking=False)
        for leaf in _flat(t["params"]).values():  # a later step, in place
            leaf.add_(1)
        if step == 1:
            ck.wait()
            _same_tree(ck.restore(1, device="cpu"), expect)
    ck.wait()
    assert ck.all_steps() == [3, 4, 5]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(device="cpu")


def test_elastic_restore_onto_cpu_and_its_refusals(tmp_path):
    cfg = TC.ARCHS["starcoder2-3b"].smoke()
    api = build_model(cfg)
    params = materialize(api.param_specs, 0, "cpu")
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(2, {"params": params, "meta": {"step": np.asarray(2)}})
    tree = elastic_restore(ck, api.param_specs, device="cpu")
    _same_tree(tree["params"], params)
    assert int(tree["meta"]["step"]) == 2
    # a leaf whose shape or dtype is not the declared one
    bad = dict(params, embed=params["embed"][:-1])
    ck.save(3, {"params": bad})
    with pytest.raises(ValueError, match="embed"):
        elastic_restore(ck, api.param_specs, device="cpu")
    bad = dict(params, embed=params["embed"].float())
    ck.save(4, {"params": bad})
    with pytest.raises(ValueError, match="embed"):
        elastic_restore(ck, api.param_specs, device="cpu", step=4)
    missing = dict(params)
    del missing["ln_f"]
    ck.save(5, {"params": missing})
    with pytest.raises(ValueError, match="ln_f"):
        elastic_restore(ck, api.param_specs, device="cpu")
    _same_tree(elastic_restore(ck, api.param_specs, device="cpu", step=2)["params"], params)
