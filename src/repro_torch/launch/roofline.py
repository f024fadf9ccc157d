"""Aggregate the port's dry-run artifacts into the roofline table —
counterpart of ``repro.launch.roofline``, over ``artifacts/dryrun_torch/``
(``REPRO_TORCH_DRYRUN_DIR``); the terms are the H100's
(``comm_analysis``).

    PYTHONPATH=src python -m repro_torch.launch.roofline            # markdown table
    PYTHONPATH=src python -m repro_torch.launch.roofline --pick     # hillclimb picks
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import ART_DIR

__all__ = ["fmt_row", "load", "main", "picks", "table"]


def load(mesh: str = "single", art_dir: str = None):
    recs = []
    for f in sorted(glob.glob(os.path.join(art_dir or ART_DIR, f"*__{mesh}.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_row(r) -> str:
    if r["status"] == "skipped":
        return f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped | — | — | — |"
    if r["status"] != "ok":
        return f"| {r['arch']} | {r['shape']} | ERROR: {r['error'][:50]} |"
    t = r["roofline"]
    mem = r.get("bytes_per_device", 0) / 2**30
    fits = "yes" if r.get("fits_hbm") else "no"
    return (
        f"| {r['arch']} | {r['shape']} | {t['t_compute_s']:.4f} | "
        f"{t['t_memory_s']:.4f} | {t['t_collective_s']:.4f} | "
        f"{t['dominant']} | {t['roofline_fraction']:.3f} | "
        f"{t.get('useful_ratio', 0):.2f} | {mem:.1f} | {fits} |"
    )


def table(mesh: str = "single", art_dir: str = None) -> str:
    rows = [
        "| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | dominant | "
        "roofline frac | 6ND/HLO | GiB/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh, art_dir):
        rows.append(fmt_row(r))
    return "\n".join(rows)


def picks(art_dir: str = None):
    """Choose the three hillclimb cells per the assignment rubric."""
    recs = [r for r in load("single", art_dir) if r["status"] == "ok"]
    by_frac = sorted(recs, key=lambda r: r["roofline"]["roofline_fraction"])
    worst = by_frac[0]
    coll = sorted(
        recs,
        key=lambda r: -(
            r["roofline"]["t_collective_s"]
            / max(sum((r["roofline"]["t_compute_s"], r["roofline"]["t_memory_s"],
                       r["roofline"]["t_collective_s"])), 1e-30)
        ),
    )[0]
    # most representative of the paper: the MoE giant (batch of per-expert
    # GEMMs == the paper's batch-matmul setting + coded serving target)
    rep = next(r for r in recs if r["arch"] == "kimi-k2-1t-a32b" and r["shape"] == "train_4k")
    return worst, coll, rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--pick", action="store_true")
    args = ap.parse_args(argv)
    if args.pick:
        w, c, r = picks()
        for label, rec in [("worst-fraction", w), ("most-collective", c),
                           ("paper-representative", r)]:
            t = rec["roofline"]
            print(
                f"{label}: {rec['arch']} x {rec['shape']} "
                f"(frac={t['roofline_fraction']:.3f}, dom={t['dominant']}, "
                f"t=({t['t_compute_s']:.3f},{t['t_memory_s']:.3f},{t['t_collective_s']:.3f}))"
            )
        return
    print(table(args.mesh))


if __name__ == "__main__":
    main()
