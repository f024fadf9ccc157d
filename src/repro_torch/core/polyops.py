"""Polynomial evaluation / interpolation over Galois rings.

Counterpart of ``repro.core.polyops``.  Host-side (``s_``-prefixed, exact
python ints) variants build setup-time constants (RMFE matrices, fixed
evaluation points).  The torch variants handle *runtime* point sets —
decoding from whichever R workers responded — as eager code: ``lax.scan``
becomes a Python loop and the ``vmap`` over basis polynomials a batch axis.
"""
from __future__ import annotations

import numpy as np
import torch

from .galois import Ring

__all__ = [
    "s_vandermonde",
    "s_lagrange_coeff_matrix",
    "as_u32",
    "vandermonde",
    "eval_poly_horner",
    "lagrange_coeff_matrix",
    "interpolate_coeffs",
]

# ---------------------------------------------------------------------------
# host-side exact versions
# ---------------------------------------------------------------------------


def s_vandermonde(ring: Ring, points: np.ndarray, K: int) -> np.ndarray:
    """V[i, k] = points[i]^k for k < K. Shape (n, K, D), object dtype."""
    n = points.shape[0]
    V = np.zeros((n, K, ring.D), dtype=object)
    for i in range(n):
        acc = ring.s_one()
        for k in range(K):
            V[i, k] = acc
            if k + 1 < K:
                acc = ring.s_mul(acc, points[i].astype(object))
    return V


def s_lagrange_coeff_matrix(ring: Ring, points: np.ndarray) -> np.ndarray:
    """M[k, i] = k-th coefficient of the i-th Lagrange basis polynomial.

    For values y_i at ``points``, the interpolating polynomial of degree < n
    has coefficients  c_k = sum_i M[k, i] * y_i.  Shape (n, n, D), object.
    """
    n = points.shape[0]
    pts = [points[i].astype(object) for i in range(n)]
    # full = prod (x - x_j): coefficients full[0..n], monic
    full = np.zeros((n + 1, ring.D), dtype=object)
    full[0] = ring.s_one()
    deg = 0
    for j in range(n):
        new = np.zeros_like(full)
        for k in range(deg, -1, -1):
            new[k + 1] = ring.s_add(new[k + 1], full[k])
            new[k] = ring.s_sub(new[k], ring.s_mul(full[k], pts[j]))
        full = new
        deg += 1
    M = np.zeros((n, n, ring.D), dtype=object)
    for i in range(n):
        # synthetic division: num_i = full / (x - x_i), degree n-1
        b = np.zeros((n, ring.D), dtype=object)
        b[n - 1] = full[n]
        for k in range(n - 1, 0, -1):
            b[k - 1] = ring.s_add(full[k], ring.s_mul(pts[i], b[k]))
        # lambda_i = 1 / num_i(x_i)
        val = ring.s_zero()
        for k in range(n - 1, -1, -1):
            val = ring.s_add(ring.s_mul(val, pts[i]), b[k])
        lam = ring.s_inv(val)
        for k in range(n):
            M[k, i] = ring.s_mul(lam, b[k])
    return M


def as_u32(obj_arr: np.ndarray) -> np.ndarray:
    return np.vectorize(int, otypes=[np.uint64])(obj_arr).astype(np.uint32)


# ---------------------------------------------------------------------------
# torch versions (runtime point sets)
# ---------------------------------------------------------------------------


def vandermonde(ring: Ring, points: torch.Tensor, K: int) -> torch.Tensor:
    """V[i, k] = points[i]^k, shape (n, K, D)."""
    acc = ring.ones((points.shape[0],), points.device)
    cols = []
    for _ in range(K):
        cols.append(acc)
        acc = ring.mul(acc, points)
    return torch.stack(cols, dim=1)


def eval_poly_horner(ring: Ring, coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate sum_k coeffs[k] x^k; coeffs (K, ..., D), x (D,) -> (..., D)."""
    acc = torch.zeros_like(coeffs[0])
    for k in range(coeffs.shape[0] - 1, -1, -1):
        acc = ring.add(ring.mul(acc, x), coeffs[k])
    return acc


def lagrange_coeff_matrix(ring: Ring, points: torch.Tensor) -> torch.Tensor:
    """M[k, i]: coefficients of the Lagrange basis polynomials, (n, n, D).

    ``points`` (n, D) may be a runtime value (the responsive workers'
    points); all pairwise differences must be units.
    """
    n, D = points.shape
    # full product prod_j (x - x_j): c'_k = c_{k-1} - x_j c_k
    full = torch.zeros((n + 1, D), dtype=ring.dtype, device=points.device)
    full[0, 0] = 1
    for j in range(n):
        shifted = torch.zeros_like(full)
        shifted[1:] = full[:-1]
        full = ring.sub(shifted, ring.mul(full, points[j][None, :]))
    # every basis polynomial at once, batched over the points x_i:
    # synthetic division by (x - x_i): b[n-1] = full[n], b[k-1] = full[k] + x_i b[k]
    b = [None] * n
    b[n - 1] = full[n].expand(n, D)
    for k in range(n - 1, 0, -1):
        b[k - 1] = ring.add(full[k][None, :], ring.mul(points, b[k]))
    # lambda_i = 1 / num_i(x_i), num_i evaluated by Horner
    val = torch.zeros((n, D), dtype=ring.dtype, device=points.device)
    for k in range(n - 1, -1, -1):
        val = ring.add(ring.mul(val, points), b[k])
    lam = ring.inv(val)
    basis = torch.stack(b, dim=1)  # (n_i, n_k, D)
    basis = ring.mul(lam[:, None, :], basis)
    return basis.movedim(0, 1).contiguous()  # (k, i, D)


def interpolate_coeffs(
    ring: Ring, points: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Coefficients (n, ..., D) of the unique deg<n poly through the points.

    values: (n, ..., D).
    """
    M = lagrange_coeff_matrix(ring, points)  # (n, n, D)
    batch = values.shape[1:-1]
    flat = values.reshape(values.shape[0], -1, ring.D)
    out = ring.matmul(M, flat)
    return out.reshape((M.shape[0],) + batch + (ring.D,))
