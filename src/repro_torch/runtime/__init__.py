"""Runtime helpers — counterpart of ``repro.runtime``: ``elastic.replan_batch``
and the single-card part of ``sharding`` (``ParamSpec``, ``materialize``)."""
from .elastic import replan_batch

__all__ = ["replan_batch"]
