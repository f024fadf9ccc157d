"""GPipe-style pipeline parallelism over a mesh axis (designed for "pod") —
counterpart of ``repro.runtime.pipeline``.

The layer stack (a leading stack dim on every leaf) is sharded over the
pipeline axis; inside a ``shard_map`` island (``local_map``) each rank runs
its stage's slice, and a GPipe schedule runs M microbatches over P stages
with ``ppermute`` hops (``permute_tensor``).  The schedule is a Python loop
over the M + P - 1 ticks, as the reference's ``lax.scan``; every stage
computes every tick (bubble = (P-1)/(M+P-1) wasted ticks).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as coll
from .sharding import shard_map

__all__ = ["pipeline_body", "pipelined_apply"]


def pipeline_body(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh, axis: str,
                  microbatches: int) -> torch.Tensor:
    """Per-rank GPipe body (inside a ``shard_map`` over ``axis``).

    ``stage_fn(stage_params, xmb) -> ymb`` applies THIS stage's layer slice.
    x: (B, ...) replicated batch; returns y: (B, ...) replicated.
    """
    nstages = coll.axis_size(mesh, axis)
    s = coll.axis_index(mesh, axis)
    M = microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"{M} microbatches do not divide the batch {B}")
    mb = x.reshape(M, B // M, *x.shape[1:])
    perm = [(i, i + 1) for i in range(nstages - 1)]
    buf = torch.zeros_like(mb[0])
    outs = torch.zeros((M,) + mb.shape[1:], dtype=x.dtype, device=x.device)
    for t in range(M + nstages - 1):
        # stage 0 ingests microbatch t (the last one again past the end)
        inp = mb[min(t, M - 1)] if s == 0 else buf
        out = stage_fn(stage_params, inp)
        # the last stage collects microbatch t - (P - 1)
        oidx = t - (nstages - 1)
        if s == nstages - 1 and oidx >= 0:
            outs = outs.index_copy(0, torch.tensor([min(oidx, M - 1)], device=x.device),
                                   out[None].to(outs.dtype))
        buf = coll.ppermute(out, mesh, axis, perm)
    # broadcast the final outputs from the last stage to all stages
    outs = coll.psum(outs if s == nstages - 1 else torch.zeros_like(outs), mesh, axis)
    return outs.reshape(B, *x.shape[1:])


def pipelined_apply(stage_fn: Callable, params_stacked, x: torch.Tensor, mesh, *,
                    axis: str = "pod", microbatches: int = 4) -> torch.Tensor:
    """The island: every leaf of ``params_stacked`` sharded on its leading
    (stack) dim over ``axis``, ``x`` replicated, the output replicated (a
    DTensor; plain inputs count as replicated full values)."""
    def spec_tree(t):
        if isinstance(t, dict):
            return {k: spec_tree(v) for k, v in t.items()}
        return (axis,) + (None,) * (t.ndim - 1)

    def body(p, xx):
        return pipeline_body(stage_fn, p, xx, mesh=mesh, axis=axis, microbatches=microbatches)

    with coll.host_staging(mesh):
        return shard_map(mesh, body, (None,), (params_stacked, x),
                         in_specs=(spec_tree(params_stacked), None))
