"""Polynomial evaluation / interpolation over Galois rings.

Counterpart of ``repro.core.polyops``.  Host-side (``s_``-prefixed, exact
python ints) variants build setup-time constants (RMFE matrices, fixed
evaluation points).  The torch variants handle *runtime* point sets —
decoding from whichever R workers responded — as eager code: ``lax.scan``
becomes a Python loop and the ``vmap`` over basis polynomials a batch axis.

The codes' decoders do not build matrices on the device: a decode matrix
depends only on the live set (R <= 16 worker indices), so it is built once
on the host with the exact ``s_*`` ops (``s_inverse``, ``s_matmul``),
uploaded, kept in a :class:`LiveSetCache`, and applied with one ring matmul.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

from .galois import Ring, from_numpy

__all__ = [
    "DECODE_CACHE_SIZE",
    "LiveSetCache",
    "s_vandermonde",
    "s_lagrange_coeff_matrix",
    "s_matmul",
    "s_inverse",
    "as_u32",
    "live_set",
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


def s_matmul(ring: Ring, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Exact ring matmul of object arrays: (n, k, D) x (k, m, D) -> (n, m, D)."""
    n, k, _ = A.shape
    m = B.shape[1]
    C = np.zeros((n, m, ring.D), dtype=object)
    for i in range(n):
        for j in range(m):
            acc = ring.s_zero()
            for c in range(k):
                acc = acc + ring.s_mul(A[i, c], B[c, j])
            C[i, j] = acc % ring.q
    return C


def s_inverse(ring: Ring, M: np.ndarray) -> np.ndarray:
    """Inverse of an (n, n, D) matrix over the ring, exact on the host.

    Unit-pivot Gauss-Jordan on [M | I], the elimination of the reference's
    ``gr_solve`` (``repro/core/gcsa.py``): over a local ring M is invertible
    iff every elimination column holds a unit pivot, so a column without
    one raises ``ValueError`` with the reference's message.  The inverse of
    an invertible matrix is unique, so ``s_inverse(M) @ Y`` is bit for bit
    what the reference's solve returns.
    """
    n = M.shape[0]
    work = np.zeros((n, 2 * n, ring.D), dtype=object)
    work[:, :n] = np.asarray(M, dtype=object) % ring.q
    for i in range(n):
        work[i, n + i] = ring.s_one()
    for k in range(n):
        piv = next((i for i in range(k, n) if ring.s_is_unit(work[i, k])), None)
        if piv is None:
            raise ValueError(
                f"gr_solve: singular system over {ring}: no unit pivot "
                f"in elimination column {k} (matrix not invertible mod "
                f"p — e.g. a decode live set indexing dependent "
                f"responses)"
            )
        work[[k, piv]] = work[[piv, k]]
        inv = ring.s_inv(work[k, k])
        work[k] = np.array([ring.s_mul(inv, x) for x in work[k]], dtype=object).reshape(
            2 * n, ring.D)
        for i in range(n):
            f = work[i, k].copy()  # a view would change as row i does
            if i == k or not any(f):
                continue
            for j in range(2 * n):
                if any(work[k, j]):
                    work[i, j] = ring.s_sub(work[i, j], ring.s_mul(f, work[k, j]))
    return work[:, n:]


def as_u32(obj_arr: np.ndarray) -> np.ndarray:
    return np.vectorize(int, otypes=[np.uint64])(obj_arr).astype(np.uint32)


# one bound for every per-live-set cache of the port (decode matrices here,
# decode closures in ``cdmm.api.DecodeOpsMixin``)
DECODE_CACHE_SIZE = 64


class LiveSetCache:
    """LRU of device decode matrices, keyed by the live set's index tuple.

    ``get(idx, build)`` returns the cached tensor for ``idx`` or uploads
    ``build()`` (an object array (rows, R, D) of exact ring elements) to
    ``device`` in ``ring``'s storage, evicting the least recently used
    entry beyond ``size``.
    """

    def __init__(self, ring: Ring, device, size: int = DECODE_CACHE_SIZE):
        self.ring, self.device, self.size = ring, device, size
        self._entries: "OrderedDict[Hashable, torch.Tensor]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, idx) -> bool:
        return idx in self._entries

    def get(self, idx: Hashable, build: Callable[[], np.ndarray]) -> torch.Tensor:
        W = self._entries.pop(idx, None)
        if W is None:
            W = from_numpy(as_u32(build()), self.ring, self.device)
            while len(self._entries) >= self.size:
                self._entries.popitem(last=False)
        self._entries[idx] = W  # re-insert = mark most-recently-used
        return W


def live_set(idx, N: int) -> tuple:
    """The live set of a decode as a tuple of Python ints, read on the host
    (R <= 16 integers of a device tensor), and checked: indices must lie
    in [0, N), and a duplicate index raises ``ValueError`` as the
    reference's ``_check_live_set`` (``repro/core/gcsa.py``) does, since
    repeated responses make the decode system singular."""
    if isinstance(idx, torch.Tensor):
        ii = [int(i) for i in idx.reshape(-1).tolist()]
    else:
        ii = [int(i) for i in np.asarray(idx).ravel()]
    if len(set(ii)) != len(ii):
        raise ValueError(
            "decode: singular live set — duplicate worker indices "
            f"{sorted(ii)} (repeated responses carry no new "
            "information; the decode system is not invertible)"
        )
    if not all(0 <= i < N for i in ii):
        raise ValueError(f"decode: live set {ii} out of range for N={N} workers")
    return tuple(ii)


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
