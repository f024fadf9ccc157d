"""Roofline terms of a dry-run cell — counterpart of
``repro.launch.hlo_analysis``.

    compute term    = FLOPs a chip / peak FLOP/s
    memory term     = HBM bytes a chip / HBM bytes/s
    collective term = collective bytes a chip / the slowest link the mesh's
                      axes cross

The reference reads its collectives from the compiled HLO text
(``_shape_bytes``, ``_split_computations``, ``_trip_count``); the port has no
HLO, so those have no counterpart: the collective term reads
``launch.steps.lower_cell``'s records, one per ``_c10d_functional``
collective that the fake run issued, with its result bytes (the reference's
approximation of the payload a hop).  The fake run executes every loop
iteration, so there is no trip count to recover, and
``hlo_flops_per_chip_raw`` (the recorder's count of the local ops' FLOPs)
is the whole step's, not XLA's once-per-while-body undercount;
``hlo_bytes_per_chip_raw`` is the ops' operand and result bytes, the
counterpart of XLA's "bytes accessed".  As in the reference, the compute
and memory terms come from the analytic model when it is given.

The constants are one NVIDIA H100 SXM's (data sheet; the card as
``nvidia-smi --query-gpu=name,power.limit`` gives it: NVIDIA H100 80GB
HBM3, 700 W): 989.4e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3, 450e9 B/s of
NVLink 4 a direction within an 8-GPU node, and 50e9 B/s (400 Gb/s) a GPU
across nodes.

Link rule: ranks fill 8-GPU nodes in order, the mesh's last axis fastest.
An axis whose groups stay inside one node is charged at NVLink's rate;
an axis that spans nodes (a 16-wide ``"model"`` axis spans two) at the
inter-node rate.  The collective term charges all collective bytes at the
slowest link that any of the mesh's axes crosses.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

__all__ = [
    "DEVICE", "HBM_BW", "HBM_BYTES", "INTERNODE_BW", "NODE_GPUS", "NVLINK_BW", "PEAK_FLOPS",
    "collective_bytes", "link_bandwidth", "model_flops", "roofline_terms",
]

DEVICE = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989.4e12   # bf16 dense, per GPU
HBM_BW = 3.35e12        # bytes/s per GPU (HBM3)
HBM_BYTES = 80e9        # the card's 80 GB
NVLINK_BW = 450e9       # bytes/s a direction, NVLink 4 within a node
INTERNODE_BW = 50e9     # bytes/s a GPU across nodes (400 Gb/s)
NODE_GPUS = 8


def link_bandwidth(sizes: Mapping[str, int]) -> float:
    """The slowest link that any axis of a mesh of ``sizes`` (axis -> size,
    in mesh order) crosses, under the rule in the module docstring."""
    names = list(sizes)
    bw = NVLINK_BW
    for i, a in enumerate(names):
        stride = int(np.prod([sizes[b] for b in names[i + 1:]])) if i + 1 < len(names) else 1
        span = (sizes[a] - 1) * stride + 1  # consecutive ranks one group covers
        if sizes[a] > 1 and span > NODE_GPUS:
            bw = min(bw, INTERNODE_BW)
    return bw


def collective_bytes(collectives: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The reference's record: result bytes by kind, plus ``"count"``."""
    out: Dict[str, float] = {}
    n = 0
    for kind, rec in collectives.items():
        out[kind] = out.get(kind, 0.0) + float(rec["bytes"])
        n += int(rec["count"])
    out["count"] = n
    return out


def roofline_terms(cost: Dict, comm: Dict[str, Dict[str, float]], chips: int,
                   analytic=None, sizes: Optional[Mapping[str, int]] = None) -> Dict[str, float]:
    """Three roofline terms in seconds, with the reference's keys.

    ``cost``: ``{"flops", "bytes accessed"}`` a chip (``lower_cell``'s
    ``flops`` and ``bytes_accessed``); ``comm``: its ``collectives``;
    ``sizes``: the mesh's axis sizes for the link rule (default: every
    axis crosses nodes).  compute/memory come from the analytic model when
    provided (global, divided by ``chips``); the raw counts go alongside."""
    flops_raw = float(cost.get("flops", 0.0) or 0.0)
    bytes_raw = float(cost.get("bytes accessed", 0.0) or 0.0)
    coll = collective_bytes(comm)
    cbytes = float(sum(v for k, v in coll.items() if k != "count"))
    if analytic is not None:
        flops = analytic.total_flops / chips
        mem_bytes = analytic.hbm_bytes / chips
    else:
        flops, mem_bytes = flops_raw, bytes_raw
    link = link_bandwidth(sizes) if sizes is not None else INTERNODE_BW
    t_compute = flops / PEAK_FLOPS
    t_memory = mem_bytes / HBM_BW
    t_collective = cbytes / link
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    rec = {
        "hlo_flops_per_chip_raw": flops_raw,
        "hlo_bytes_per_chip_raw": bytes_raw,
        "flops_per_chip": flops,
        "bytes_per_chip": mem_bytes,
        "collective_bytes_per_chip": cbytes,
        "collective_ops": coll,
        "link_bytes_per_s": link,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "roofline_fraction": (
            t_compute / max(t_compute, t_memory, t_collective, 1e-30)
        ),
    }
    if analytic is not None:
        rec["model_flops"] = analytic.model_flops
        rec["useful_ratio"] = analytic.model_flops / max(analytic.total_flops, 1e-30)
        rec["param_count"] = analytic.param_count
        rec["active_param_count"] = analytic.active_param_count
    return rec


def model_flops(cfg, shape, param_count: int, active_param_count: int) -> float:
    """6*N*D for train, 2*N*D for forward-only, per the assignment."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n = active_param_count
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n * tokens
