"""Hand-written Hopper kernels for the CDMM hot paths, with plain versions.

gr_matmul: Galois-ring matmul (worker compute, encode, decode, RMFE
phi/psi) in five routes, CUDA C++ under ``csrc/`` built at first use:
``simt`` (``gr_matmul.cu``: thin calls over GR(2^e, D <= 4) on the int8
tensor cores, the rest on the CUDA cores), ``tc`` (``gr_matmul_tc.cu``,
int8 tensor cores; GR(2^e, D > 4) and two-level towers lifted onto their
inner ring),
``tc_left`` (``gr_matmul_tc_left.cu``, a lifted ring's calls with a small
left operand), ``skinny`` (``gr_matmul_skinny.cu``) and ``tower``
(``gr_matmul_tower.cu``, the skinny calls of the rings ``skinny`` has no
instantiation for);
``ops.pick_route`` picks (its docstring states the routes' envelope).
"""
from .gr_matmul import MAX_D, counters, gr_matmul_planar, gr_matmul_simt
from .ops import (
    coded_encode,
    gr_matmul,
    kernel_auto_enabled,
    kernel_supported,
    pick_blocks,
    pick_route,
    run_route,
)
from .ref import (
    gr_matmul_limbs_ref,
    gr_matmul_planar_ref,
    gr_matmul_ref,
    gr_matmul_simt_ref,
    gr_matmul_tc_left_ref,
    gr_matmul_tc_ref,
    gr_matmul_tower_ref,
)

__all__ = [
    "MAX_D",
    "counters",
    "gr_matmul",
    "gr_matmul_planar",
    "gr_matmul_simt",
    "coded_encode",
    "kernel_supported",
    "kernel_auto_enabled",
    "pick_blocks",
    "pick_route",
    "run_route",
    "gr_matmul_ref",
    "gr_matmul_limbs_ref",
    "gr_matmul_planar_ref",
    "gr_matmul_simt_ref",
    "gr_matmul_tc_left_ref",
    "gr_matmul_tc_ref",
    "gr_matmul_tower_ref",
]
