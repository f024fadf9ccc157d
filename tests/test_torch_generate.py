"""repro_torch.launch.serve's greedy generation held against
repro.launch.serve's (JAX on the CPU), end to end, at gemma2-2b's smoke
size with the reference's weights (``materialize(specs, PRNGKey(seed))``)
and prompt (``default_rng(seed)``).

The logits tolerance is bf16's model-level one (``BF16_MODEL`` = 5e-2
relative L2, see tests/test_torch_models.py).  bf16 logits tie or nearly
tie, so a generated token must equal the reference's wherever the
reference's top-2 gap exceeds twice the largest error the tolerance admits
in that row (``2 * BF16_MODEL * max|logits|``): no error within it can
reorder them.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.launch.serve import greedy_generate as ref_generate
from repro.models import build_model as ref_build
from repro.runtime import sharding as RS

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch.serve import greedy_generate, main
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime.sharding import _map_leaves, materialize

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH, SEED = "gemma2-2b", 0
BF16_MODEL = 5e-2


@pytest.fixture(scope="module")
def reference():
    """The reference's generation, its weights, and its logits at every
    step of the same token sequence (prompt, then the generated tokens)."""
    cfg = RC.ARCHS[ARCH].smoke()
    api = ref_build(cfg)
    params = RS.materialize(api.param_specs, jax.random.PRNGKey(SEED))
    out = ref_generate(ARCH, seed=SEED)
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 8))
    seq = np.concatenate([prompt, out["generated"]], axis=1).astype(np.int32)
    decl = api.cache_decl(RC.ShapeConfig("serve", 8 + 8 + 8, 2, "decode"))
    cache = jax.tree.map(lambda ps: jnp.zeros(ps.shape, ps.dtype), decl,
                         is_leaf=lambda x: isinstance(x, RS.ParamSpec))
    decode = jax.jit(api.decode_fn)
    logits = []
    for t in range(seq.shape[1]):
        lg, cache = decode(params, cache, {"tokens": jnp.asarray(seq[:, t:t + 1])})
        logits.append(np.asarray(lg[:, -1]))
    return {"generated": out["generated"], "seq": seq, "logits": logits,
            "params": jax.tree.map(np.asarray, params)}


def _gap_exceeds(row: np.ndarray) -> bool:
    top2 = np.sort(row)[-2:]
    return top2[1] - top2[0] > 2 * BF16_MODEL * np.abs(row).max()


def test_greedy_generate_matches_reference(reference):
    out = greedy_generate(ARCH, seed=SEED, device="cpu",
                          params=params_from_numpy(reference["params"], "cpu"))
    assert out["generated"].shape == (2, 8) and out["generated"].dtype == np.int32
    assert np.array_equal(out["prompt"], reference["seq"][:, :8])
    assert len(out["step_ms"]) == 16 and all(ms > 0 for ms in out["step_ms"])
    # free running: tokens agree up to the first step where a reference
    # row's top-2 gap is within the tolerance (after it, both runs may
    # legitimately follow different tokens)
    for b in range(2):
        for j in range(8):
            if not _gap_exceeds(reference["logits"][7 + j][b]):
                break
            assert out["generated"][b, j] == reference["generated"][b, j], (b, j)
    assert out["logits"].shape == (2, 1, 512) and bool(torch.isfinite(out["logits"]).all())


def test_teacher_forced_logits_and_tokens(reference):
    """The reference's token sequence fed through the port's decode loop:
    every step's logits within the bf16 tolerance, every argmax equal where
    the reference's top-2 gap exceeds it."""
    api = build_model(ARCHS[ARCH].smoke())
    params = params_from_numpy(reference["params"], "cpu")
    cache = _map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=ps.dtype),
                        api.cache_decl(ShapeConfig("serve", 24, 2, "decode")))
    seq = torch.from_numpy(reference["seq"])
    checked = 0
    with torch.inference_mode():
        for t in range(seq.shape[1]):
            lg, cache = api.decode_fn(params, cache, {"tokens": seq[:, t:t + 1]})
            got, ref = lg[:, -1].double().numpy(), reference["logits"][t].astype(np.float64)
            assert np.linalg.norm(got - ref) <= BF16_MODEL * np.linalg.norm(ref), t
            for b in range(2):
                if _gap_exceeds(ref[b]):
                    assert got[b].argmax() == ref[b].argmax(), (t, b)
                    checked += 1
    assert cache["len"] == seq.shape[1]
    assert checked > 0


def test_cli_generates_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--gen-len", "2"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert res.returncode == 0, res.stderr
    assert "generated tokens" in res.stdout
    rows = [ln for ln in res.stdout.splitlines() if ln.strip().startswith(("[[", "["))]
    assert len(rows) == 2 and all(len(r.strip("[] ").split()) == 2 for r in rows)


def test_cli_rejects_an_unknown_arch():
    with pytest.raises(SystemExit):
        main(["--arch", "nope", "--device", "cpu"])


def test_generation_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--gen-len", "1"])
    specs = build_model(ARCHS[ARCH].smoke()).param_specs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize(specs, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"x": np.zeros(2, np.float32)})
