"""Entry points — counterpart of ``repro.launch`` (of it, only the coded and
serving paths of ``serve.py`` so far)."""
