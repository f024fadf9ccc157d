"""Deterministic sharded data pipeline — a copy of ``repro.data.pipeline``
(numpy only: the same bits for the same seed, step and shard).

Three sources:
  * synthetic: seeded per (epoch-less) step index — restart at step k replays
    exactly the same batches (fault-tolerance requirement: checkpoint stores
    only the step counter, no loader state).
  * markov: the same, as learnable per-row progressions mod the vocab.
  * binfile: memory-mapped flat token file (uint16/uint32), strided by
    (step, shard) so every data shard reads a disjoint slice.

Batches are host numpy; the launcher copies them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"  # synthetic | markov | binfile
    path: Optional[str] = None
    seed: int = 1234
    dtype: str = "uint16"


def _synth_tokens(seed: int, step: int, shard: int, shape, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard]))
    return rng.integers(0, vocab, shape, dtype=np.int64).astype(np.int32)


def _markov_tokens(seed: int, step: int, shard: int, shape, vocab: int) -> np.ndarray:
    """Learnable synthetic stream: per-row arithmetic progressions mod V.

    A model that infers the stride from context predicts every next token —
    gives real loss curves on CPU-scale runs without shipping a corpus."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, shard, 3]))
    B, S = shape
    start = rng.integers(0, vocab, (B, 1))
    stride = rng.integers(1, min(64, vocab - 1), (B, 1))
    idx = np.arange(S)[None, :]
    return ((start + stride * idx) % vocab).astype(np.int32)


class TokenPipeline:
    """Yields {tokens, labels} host batches for a (model, shape) cell."""

    def __init__(
        self,
        dcfg: DataConfig,
        mcfg: ModelConfig,
        shape: ShapeConfig,
        shard: int = 0,
        num_shards: int = 1,
    ):
        self.dcfg, self.mcfg, self.shape = dcfg, mcfg, shape
        self.shard, self.num_shards = shard, num_shards
        # ceil so a degraded shard count still covers the global batch
        self.local_batch = max(1, -(-shape.global_batch // num_shards))
        self._mm = None
        if dcfg.source == "binfile":
            if not dcfg.path:
                raise ValueError("binfile source needs a path")
            self._mm = np.memmap(dcfg.path, dtype=np.dtype(dcfg.dtype), mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.local_batch, self.shape.seq_len
        V = self.mcfg.vocab_size
        if self.dcfg.source == "markov":
            toks = _markov_tokens(self.dcfg.seed, step, self.shard, (B, S + 1), V)
        elif self._mm is None:
            toks = _synth_tokens(self.dcfg.seed, step, self.shard, (B, S + 1), V)
        else:
            n = len(self._mm)
            span = B * (S + 1)
            start = (step * self.num_shards + self.shard) * span % max(n - span, 1)
            flat = np.asarray(self._mm[start : start + span], dtype=np.int64)
            toks = (flat % V).astype(np.int32).reshape(B, S + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # extra modalities (stub frontends per assignment) -----------------------

    def with_frontend(self, batch: Dict[str, np.ndarray], step: int) -> Dict:
        cfg = self.mcfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.dcfg.seed, step, self.shard, 7])
        )
        if cfg.frontend == "patch":
            B = batch["tokens"].shape[0]
            batch = dict(batch)
            batch["patches"] = rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)
            ).astype(np.float32)
        elif cfg.frontend == "frames":
            B, S = batch["tokens"].shape
            Ssrc = max(S // cfg.src_ratio, 16)
            batch = dict(batch)
            batch["frames"] = rng.standard_normal((B, Ssrc, cfg.frontend_dim)).astype(
                np.float32
            )
        return batch
