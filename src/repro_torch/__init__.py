"""PyTorch/CUDA port of ``repro``: coded distributed (batch) matrix
multiplication over Galois rings via RMFE, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX.  Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`resolve_device`).  Every ring matmul on the card goes through the
hand-written kernel in ``repro_torch.kernels``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
