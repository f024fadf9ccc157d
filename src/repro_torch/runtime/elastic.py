"""Elastic scaling — counterpart of ``repro.runtime.elastic``: restore any
checkpoint onto any mesh, or onto one device (``elastic_restore``), and
re-chunk a batch across a changing pool (``replan_batch``).

The checkpoint format is placement-agnostic (host-gathered full arrays plus
the data step for deterministic replay), so a checkpoint written by either
package, on any mesh or none, restores here: growing or shrinking the mesh
is a restore with new placements (``sharding_tree``).
"""
from __future__ import annotations

from typing import Dict, Optional

from ..checkpoint import Checkpointer
from .sharding import _leaf_paths, distribute_tree

__all__ = ["elastic_restore", "replan_batch"]


def elastic_restore(
    ckpt: Checkpointer,
    param_specs: Dict,
    mesh=None,
    rules: Optional[Dict] = None,
    step: Optional[int] = None,
    device=None,
) -> Dict:
    """Load the checkpoint at ``step`` (default: the latest) onto ``device``
    (default: the card; a mesh's own device type when ``mesh`` is given),
    whatever wrote it, and check that its ``params`` hold every leaf of
    ``param_specs`` at the declared shape and dtype (``ValueError``
    otherwise).  On ``mesh`` the params are DTensors placed per
    ``sharding_tree(param_specs, mesh, rules)`` (every rank reads the
    files and keeps its shard).  Returns the whole restored tree."""
    if mesh is not None and device is None:
        device = mesh.device_type
    tree = ckpt.restore(step=step, device=device)
    params = tree.get("params")
    if params is None:
        raise ValueError(f"checkpoint in {ckpt.dir} holds no params")
    for path, ps in _leaf_paths(param_specs):
        leaf = params
        for k in path:
            if not isinstance(leaf, dict) or k not in leaf:
                raise ValueError(f"checkpoint params lack {'/'.join(path)}")
            leaf = leaf[k]
        if tuple(leaf.shape) != tuple(ps.shape) or leaf.dtype != ps.dtype:
            raise ValueError(
                f"checkpoint params {'/'.join(path)}: {tuple(leaf.shape)} {leaf.dtype}, "
                f"the specs declare {tuple(ps.shape)} {ps.dtype}")
    if mesh is not None:
        tree["params"] = distribute_tree(params, param_specs, mesh, rules)
    return tree


def replan_batch(global_batch: int, live_data_shards: int) -> int:
    """After losing (or gaining) nodes, keep the global batch by resizing the
    per-shard batch — returns the new local batch.

    When ``live_data_shards`` does not divide ``global_batch`` the per-shard
    batch is the ceiling, so ``per * live >= global`` and the trailing shard
    runs partially filled (callers pad or mask the remainder).  The CDMM
    elastic stream (``repro_torch.cdmm.elastic``) calls this on every
    membership change to re-chunk a batch stream across the live pool.
    """
    if global_batch < 1:
        raise ValueError(f"global_batch must be >= 1, got {global_batch}")
    if live_data_shards < 1:
        raise ValueError(
            f"cannot replan onto {live_data_shards} live shards; "
            "need at least one survivor"
        )
    return -(-global_batch // live_data_shards)
