"""Entry points — counterpart of ``repro.launch``: ``serve`` (token
generation, the coded and the serving paths), ``train`` (on one device or
a mesh), ``steps`` (cells, ``rules_for``, ``lower_cell``), ``mesh``, the
dry-run (``dryrun``, ``costmodel``, ``comm_analysis``) and ``roofline``."""
