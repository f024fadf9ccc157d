"""Entry points — counterpart of ``repro.launch`` (of it, ``serve.py``:
token generation, the coded and the serving paths)."""
