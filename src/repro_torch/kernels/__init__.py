"""Hand-written Hopper kernels for the CDMM hot paths, with plain versions.

gr_matmul: planar Galois-ring matmul (worker compute, encode, decode, RMFE
phi/psi), CUDA C++ in ``csrc/gr_matmul.cu``, built at first use.
"""
from .gr_matmul import MAX_D, counters, gr_matmul_planar
from .ops import (
    coded_encode,
    gr_matmul,
    kernel_auto_enabled,
    kernel_supported,
    pick_blocks,
)
from .ref import gr_matmul_planar_ref, gr_matmul_ref

__all__ = [
    "MAX_D",
    "counters",
    "gr_matmul",
    "gr_matmul_planar",
    "coded_encode",
    "kernel_supported",
    "kernel_auto_enabled",
    "pick_blocks",
    "gr_matmul_ref",
    "gr_matmul_planar_ref",
]
