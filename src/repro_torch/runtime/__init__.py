"""Runtime helpers — counterpart of ``repro.runtime`` (of it, only
``elastic.replan_batch`` so far)."""
from .elastic import replan_batch

__all__ = ["replan_batch"]
