"""The port's three examples run end to end on the CPU
(``python -m repro_torch.examples.<name> --device cpu``), each in its own
interpreter: the quickstart's plan and 4-of-8 decode, the coded int8
matmul bit-identical under dead workers, and the service over a worker pool
with a SIGKILL mid-stream, then the shard_map comparison path over 8 ranks.
Each exits non-zero on a wrong result."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

EXPECT = {
    "quickstart": ["planner picked", "recovered both products exactly from 4/8 workers on cpu"],
    "coded_inference": ["4 dead workers", "bit-identical=True", "coding adds 0.0"],
    "coded_matmul_service": ["pool req 4: exact=True", "mid-stream",
                             "shard_map req 4: dead workers"],
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs_on_the_cpu(name, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC), "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}", "--device", "cpu"],
                         capture_output=True, text=True, env=env, timeout=240, cwd=tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    for line in EXPECT[name]:
        assert line in res.stdout, (line, res.stdout[-2000:])
    assert "exact=False" not in res.stdout and "bit-identical=False" not in res.stdout
