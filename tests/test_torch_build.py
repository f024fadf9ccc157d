"""The kernel build is safe across processes: two processes that load the
library at once from a cold build directory compile it once.

nvcc is absent on a CPU-only machine, so each process loads
``repro_torch/kernels/build.py`` on its own (it imports only the standard
library) and stubs the three things that need the CUDA toolkit: the nvcc
lookup, the compile (which logs itself, sleeps, and writes an empty
library) and ``ctypes.CDLL``."""
import json
import os
import subprocess
import sys
from pathlib import Path

BUILD_PY = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "build.py"

CHILD = r"""
import importlib.util, json, os, sys, time
from pathlib import Path
from types import SimpleNamespace

build_py, tmp, name = sys.argv[1], Path(sys.argv[2]), sys.argv[3]
spec = importlib.util.spec_from_file_location("build_under_test", build_py)
build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(build)
build.BUILD_DIR = tmp / "kernels"

def compile_stub(nvcc, so):
    with open(tmp / "compiles.log", "a") as f:
        f.write(name + "\n")
    time.sleep(1.5)
    so.write_bytes(b"")

build._nvcc = lambda: "nvcc-stub"
build._compile = compile_stub
build.ctypes = SimpleNamespace(CDLL=lambda path: SimpleNamespace(path=path))
build._declare = lambda lib: None
# both processes start loading together
(tmp / f"ready.{name}").touch()
while len(list(tmp.glob("ready.*"))) < 2:
    time.sleep(0.01)
t0 = time.perf_counter()
build.load_library()
info = build.build_info()
print(json.dumps({"name": name, "built": info["built"], "path": info["path"],
                  "waited_s": time.perf_counter() - t0}))
"""


def test_two_processes_compile_once(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(BUILD_PY), str(tmp_path), name],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in ("a", "b")]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        outs.append(json.loads(out))
    compiles = (tmp_path / "compiles.log").read_text().split()
    assert len(compiles) == 1  # one compile between them
    builder = next(o for o in outs if o["name"] == compiles[0])
    loader = next(o for o in outs if o["name"] != compiles[0])
    assert builder["built"] and not loader["built"]
    assert builder["path"] == loader["path"] and os.path.exists(builder["path"])
    # the other process waited on the lock for the compile, then loaded
    assert loader["waited_s"] >= 1.0
    assert (tmp_path / "kernels" / "build.lock").exists()
