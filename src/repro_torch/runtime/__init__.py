"""Runtime helpers — counterpart of ``repro.runtime``: ``sharding``
(``ParamSpec``, ``materialize``, logical-axis rules and DTensor placements
on a mesh), ``collectives`` (the mesh islands' collectives), ``elastic``
(``elastic_restore`` onto a mesh or one device, ``replan_batch``) and
``pipeline`` (the GPipe schedule over a mesh axis)."""
from .elastic import elastic_restore, replan_batch

__all__ = ["elastic_restore", "replan_batch"]
