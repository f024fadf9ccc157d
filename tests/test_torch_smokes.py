"""The slice-5 command-line smokes on the CPU, each in its own interpreter:
the multi-host launcher (2 localhost hosts x 3 workers over TCP with the
compressed transport, one whole host SIGKILLed mid-request: exit 0 only if
the decode equals the oracle and the wire carried fewer bytes than raw), and
the telemetry plane's smoke (scrape, hedge, trace and ``top`` over HTTP).
The reference gates its launcher with a CI job, not a test."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC), "HOME": str(tmp_path)}
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          env=env, timeout=180, cwd=tmp_path)


def test_multihost_launcher_smoke(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("127.0.0.1 slots=3\n127.0.0.1 slots=3\n")
    res = _run(["repro_torch.dist.launch", "--smoke", "--transport", "pack+zlib",
                "--kill-hosts", "1", "--size", "96", "--device", "cpu",
                "--hostfile", str(hosts)], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "MULTIHOST SMOKE OK" in res.stdout
    assert '"bit_identical": true' in res.stdout


def test_obs_smoke(tmp_path):
    res = _run(["repro_torch.obs.smoke", "--device", "cpu"], tmp_path)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "METRICS SMOKE OK" in res.stdout
    # the hedged share shows on top's frame
    assert "hedged=" in res.stdout and "hedged=0 " not in res.stdout
