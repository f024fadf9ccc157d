"""Elastic re-chunking of a batch across a changing pool — counterpart of
``repro.runtime.elastic`` (``replan_batch``; restoring a checkpoint onto a
new mesh, ``elastic_restore``, comes with the LM substrate)."""
from __future__ import annotations

__all__ = ["replan_batch"]


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
