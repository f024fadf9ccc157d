"""Runtime helpers — counterpart of ``repro.runtime``: ``elastic``
(``elastic_restore`` onto one device, ``replan_batch``) and the single-card
part of ``sharding`` (``ParamSpec``, ``materialize``)."""
from .elastic import elastic_restore, replan_batch

__all__ = ["elastic_restore", "replan_batch"]
