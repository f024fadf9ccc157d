#!/usr/bin/env python3
"""Time phase 4 of ``chip_smoke.py`` for two checkouts in turns on one card.

    python3 tools/phase4_turns.py BASE CHANGE [--out PATH]

BASE and CHANGE are checkouts of the repo (for example the parent commit
unpacked with ``git archive`` and the working tree).  The turns run BASE,
CHANGE, CHANGE, BASE, each in a process of its own started from its
checkout's root, so each runs that checkout's ``chip_smoke.py`` and port:
phase 1 (the build; cached after a checkout's first turn), the paths of
phases 3 and 5-7 to record the calls they hand the kernels, then phase 4
on those calls (every (route, ring, shape) held against the plain version
and the timed ones timed).  The calls of phases 8-9 (the pool, the
server, the hedged request, the SPMD ranks) are left out in both, so
phase 4 here covers fewer shapes than in a whole run.

Prints one JSON line a turn (the checkout, each phase's wall seconds, the
tc_left rows' times) and, last, the phase-4 seconds of each checkout's
two turns and their mean.  Needs a CUDA card; imports neither jax nor the
JAX package.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# run from the checkout's root: its chip_smoke.py and its src/
CHILD = r"""
import json, sys, time
import chip_smoke as c
sys.path.insert(0, str(c.SRC))
report = {"phase_seconds": {}}
def timed(phase, *args):
    start = time.perf_counter()
    out = phase(report, *args)
    report["phase_seconds"][phase.__name__] = time.perf_counter() - start
    return out
timed(c.phase_env_build)
report["kernel_max_abs_err"] = dict.fromkeys(c.COUNTED, 0)
totals, calls = timed(c.phase_main_path)
for phase in (c.phase_elastic, c.phase_stream, c.phase_quantized):
    timed(phase, calls)
timed(c.phase_path_calls, calls)
left = {f"{x['ring']} {x['a']}": {k: x.get(k) for k in ("ms", "main_ms", "simt_ms")}
        for x in report["path_kernel_timings"] if x["route"] == "tc_left"}
print("TURN " + json.dumps({"phase_seconds": report["phase_seconds"], "calls": len(calls),
                            "timed_shapes": len(report["path_kernel_timings"]),
                            "tc_left": left}))
"""


def turn(tree: Path) -> dict:
    """One turn: the child process in ``tree``; its TURN line."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"phase4_turns: the turn in {tree} failed ({proc.returncode})")
    line = next(ln for ln in reversed(proc.stdout.splitlines()) if ln.startswith("TURN "))
    return json.loads(line[len("TURN "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="checkout timed first and last")
    ap.add_argument("change", type=Path, help="checkout timed in the middle turns")
    ap.add_argument("--out", type=Path, help="also write every turn's JSON here")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    turns = []
    for name, tree in (("base", args.base), ("change", args.change), ("change", args.change),
                       ("base", args.base)):
        row = {"checkout": name, **turn(tree.resolve())}
        turns.append(row)
        print(json.dumps(row), flush=True)
    phase4 = {name: [t["phase_seconds"]["phase_path_calls"] for t in turns if t["checkout"] == name]
              for name in ("base", "change")}
    summary = {"card": card, "phase4_seconds": phase4,
               "phase4_mean": {k: sum(v) / len(v) for k, v in phase4.items()}}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"turns": turns, **summary}, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
