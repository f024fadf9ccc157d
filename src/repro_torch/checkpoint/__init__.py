"""Checkpointing with async save — counterpart of ``repro.checkpoint``."""
from .checkpoint import Checkpointer

__all__ = ["Checkpointer"]
