"""Runnable examples of the port, counterparts of the reference's
``examples/``: ``python -m repro_torch.examples.<name>`` on the card by
default, ``--device cpu`` without one."""
