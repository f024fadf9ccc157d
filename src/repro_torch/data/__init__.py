"""Deterministic sharded data pipelines — counterpart of ``repro.data``."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
