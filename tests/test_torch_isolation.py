"""repro_torch stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless asked for the CPU."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

SRC = Path(__file__).resolve().parents[1] / "src"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_every_module_imports_without_jax_or_repro():
    mods = ["repro_torch"] + _modules()
    for m in ("repro_torch.kernels.gr_matmul", "repro_torch.cdmm.backends",
              "repro_torch.core.secure", "repro_torch.core.gcsa",
              "repro_torch.cdmm.elastic", "repro_torch.cdmm.quantized",
              "repro_torch.runtime.elastic", "repro_torch.core.straggler",
              "repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.export",
              "repro_torch.obs.health", "repro_torch.settings", "repro_torch.stats",
              "repro_torch.obs.http", "repro_torch.obs.top", "repro_torch.obs.smoke",
              "repro_torch.dist", "repro_torch.dist.protocol", "repro_torch.dist.config",
              "repro_torch.dist.worker", "repro_torch.dist.launch", "repro_torch.dist.master",
              "repro_torch.dist.pool_backend", "repro_torch.dist.scheduler",
              "repro_torch.dist.smoke", "repro_torch.serve", "repro_torch.serve.coalescer",
              "repro_torch.serve.stats", "repro_torch.serve.engine", "repro_torch.serve.smoke",
              "repro_torch.launch", "repro_torch.launch.serve",
              "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.gemma2_2b",
              "repro_torch.runtime.sharding", "repro_torch.models", "repro_torch.models.layers",
              "repro_torch.models.transformer", "repro_torch.models.registry",
              "repro_torch.models.convert", "repro_torch.optim", "repro_torch.optim.optimizers",
              "repro_torch.optim.compression", "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
              "repro_torch.launch.steps", "repro_torch.launch.train",
              "repro_torch.examples.train_lm", "repro_torch.launch.mesh",
              "repro_torch.launch.dryrun", "repro_torch.launch.costmodel",
              "repro_torch.launch.comm_analysis", "repro_torch.launch.roofline",
              "repro_torch.runtime.pipeline", "repro_torch.runtime.collectives"):
        assert m in mods, m
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')"
        " and sys.modules[k] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    _without_cuda(monkeypatch)
    from repro_torch.cdmm import (
        BatchRMFEAdapter,
        CSAAdapter,
        GCSAGeneralAdapter,
        ProblemSpec,
        SecureBatchRMFEAdapter,
        SecureEPAdapter,
        coded_matmul,
        plan,
    )
    from repro_torch.core import CSACode, EPCode, GCSACode, SecureEPCode, make_ring

    Z = make_ring(2, 32, ())
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Z.random(rng, (2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Z.ones((2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EPCode(make_ring(2, 32, (3,)), 8, 2, 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchRMFEAdapter(Z, 2, 8, 2, 2, 1)
    G4 = make_ring(2, 32, (4,))
    for build in (lambda: Z.random_torch(1, (2, 2)), lambda: CSACode(G4, 2, 8),
                  lambda: GCSACode(G4, 4, 8, kappa=2), lambda: SecureEPCode(G4, 8, 1, 2, 1, 1),
                  lambda: CSAAdapter(Z, 2, 8), lambda: GCSAGeneralAdapter(Z, 4, 8, 1, 1, 1, 2),
                  lambda: SecureEPAdapter(Z, 8, 1, 2, 1, 1),
                  lambda: SecureBatchRMFEAdapter(Z, 2, 8, 1, 2, 1, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    p = plan(ProblemSpec(8, 8, 8, ring=Z, N=8, straggler_budget=2))
    A = Z.random(rng, (8, 8), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coded_matmul(A, A, p)
    # the same call with device="cpu" runs
    assert torch.equal(coded_matmul(A, A, p, device="cpu"), Z.matmul(A, A))
    for spec, key in ((ProblemSpec(8, 8, 8, ring=Z, N=8, straggler_budget=2, privacy_t=1), 3),
                      (ProblemSpec(8, 8, 8, n=2, ring=Z, N=8, straggler_budget=2), None)):
        ps = plan(spec)
        As = Z.random(rng, (spec.n, 8, 8) if spec.n > 1 else (8, 8), device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            coded_matmul(As, As, ps, key=key)
        assert coded_matmul(As, As, ps, key=key, device="cpu").shape == As.shape


def test_elastic_and_quantized_default_to_cuda_and_raise_without_it(monkeypatch):
    _without_cuda(monkeypatch)
    from repro_torch.cdmm import (
        CodedQuantMatmul,
        ElasticBackend,
        ElasticStream,
        ProblemSpec,
        coded_matmul,
        plan,
    )
    from repro_torch.core import WorkerTrace, make_ring

    Z = make_ring(2, 32, ())
    p = plan(ProblemSpec(8, 8, 8, ring=Z, N=8, straggler_budget=2))
    A = Z.random(np.random.default_rng(0), (8, 8), device="cpu")
    trace = WorkerTrace(np.zeros(8), np.full(8, np.inf), np.arange(1.0, 9.0))
    for backend in ("elastic", ElasticBackend(), ElasticBackend(trace=trace)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            coded_matmul(A, A, p, backend=backend)
        assert torch.equal(coded_matmul(A, A, p, backend=backend, device="cpu"), Z.matmul(A, A))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticStream(8, 8, 8, Z)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodedQuantMatmul(8, None)
    x = torch.ones((4, 8))
    assert CodedQuantMatmul(8, None, device="cpu")(x, torch.ones((8, 4))).shape == (4, 4)


def test_pool_and_server_default_to_cuda_and_raise_without_it(monkeypatch, capsys):
    _without_cuda(monkeypatch)
    from repro_torch.dist import LocalPool, Master, PoolConfig, default_pool, launch_pool
    from repro_torch.dist import worker
    from repro_torch.serve import ServeScheduler

    for build in (Master, LocalPool, lambda: launch_pool(PoolConfig(workers=1)),
                  default_pool, ServeScheduler, lambda: ServeScheduler(config=PoolConfig())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    # the worker CLI refuses before it connects anywhere
    assert worker.main(["--connect", "unix:/nonexistent.sock"]) != 0
    assert "device='cpu'" in capsys.readouterr().err
    # the same calls with device="cpu" build (a master with no workers)
    with Master(device="cpu") as m:
        assert m.device == torch.device("cpu") and m.live_workers() == []


NEW_MODULES = ("repro_torch.kernels.autotune", "repro_torch.cdmm.calibrate",
               "repro_torch.cdmm.runtime", "repro_torch.examples",
               "repro_torch.examples.quickstart", "repro_torch.examples.coded_inference",
               "repro_torch.examples.coded_matmul_service")


def test_autotune_calibration_spmd_and_examples_default_to_cuda(monkeypatch):
    """The autotuner, the calibration's measurement, the SPMD rank pool and
    the examples are modules of the port (imported without JAX by the test
    above) whose entry points run on the card by default and raise without
    one; a CPU run names the CPU."""
    assert set(NEW_MODULES) <= set(_modules())
    _without_cuda(monkeypatch)
    from repro_torch.cdmm import calibrate
    from repro_torch.cdmm.backends import ShardMapBackend
    from repro_torch.cdmm.runtime import RankPool
    from repro_torch.core import make_ring
    from repro_torch.device import device_kind
    from repro_torch.examples import coded_inference, coded_matmul_service, quickstart
    from repro_torch.kernels import autotune

    for build in (lambda: RankPool(2), lambda: ShardMapBackend().pool(2),
                  lambda: calibrate.measure_rows(), lambda: calibrate.main([]),
                  lambda: quickstart.main([]), lambda: coded_inference.main([]),
                  lambda: coded_matmul_service.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(ValueError, match="on the card"):
        autotune.autotune(make_ring(2, 32, (3,)), 1024, 2048, 1024)
    assert device_kind() == "cpu" and device_kind("cpu") == "cpu"
    assert calibrate.fit_rows([], device=None).device == "cpu"


def test_training_path_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    """The training path's entry points (``train`` and its CLI,
    ``make_train_state``, ``Checkpointer.restore``, ``elastic_restore``, the
    ``train_lm`` example) run on the card by default and raise without one;
    with ``device="cpu"`` they run."""
    _without_cuda(monkeypatch)
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.launch.steps import opt_config_for
    from repro_torch.models import build_model
    from repro_torch.runtime import elastic_restore

    cfg = ARCHS["gemma2-2b"].smoke()
    api = build_model(cfg)
    ck = Checkpointer(str(tmp_path))
    for build in (lambda: train.train("gemma2-2b", steps=1),
                  lambda: train.main(["--arch", "gemma2-2b", "--smoke", "--steps", "1"]),
                  lambda: train.make_train_state(api, opt_config_for(cfg)),
                  lambda: ck.restore(), lambda: elastic_restore(ck, api.param_specs),
                  lambda: train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "lm")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    state = train.make_train_state(api, opt_config_for(cfg), device="cpu")
    ck.save(1, {"params": state["params"]})
    assert elastic_restore(ck, api.param_specs, device="cpu")["params"]["embed"].device.type == "cpu"
    assert state["opt"]["step"].device.type == "cpu"


def test_mesh_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The meshes are made on the card's device type unless the caller asks
    for the CPU, and raise without a card before touching any process
    group; the dry-run refuses to start beside an initialized group."""
    _without_cuda(monkeypatch)
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    for build in (lambda: make_debug_mesh(), lambda: make_production_mesh(),
                  lambda: make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    with pytest.raises(RuntimeError, match="initialized default process group"):
        make_debug_mesh(device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="already up"):
        dryrun.fake_group(8)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and
    when it stands alone outside the repository."""
    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for path in (script, tmp_path / "chip_smoke.py"):
        if path != script:
            path.write_text(script.read_text())
        res = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                             env=env, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
