"""Reverse Multiplication-Friendly Embeddings over Galois rings — counterpart
of ``repro.core.rmfe``.

An (n, m)-RMFE over GR = GR(p^e, d) is a pair of GR-linear maps
``phi: GR^n -> GR_m`` and ``psi: GR_m -> GR^n`` with
``psi(phi(x) * phi(y)) = x * y`` (elementwise).

* phi(x) = coefficients of the degree < n polynomial f_x with f_x(a_i) = x_i
  at n exceptional points, read as an element of the tower GR_m;
* psi(gamma) = evaluations of gamma's coefficient polynomial at a_1..a_n.

``ConcatRMFE`` composes two of them (paper Lemma II.5) when the base
exceptional set is too small (|T| = 2 for Z_{2^e}).  Both maps are ring
matmuls against small setup-time matrices (``M_phi``, ``V_psi``).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .galois import Ring, from_numpy
from .polyops import as_u32, s_lagrange_coeff_matrix, s_vandermonde

__all__ = ["BasicRMFE", "ConcatRMFE", "build_rmfe"]


class BasicRMFE:
    """(n, m)-RMFE over ``base`` with m = actual top extension degree."""

    def __init__(self, base: Ring, n: int, min_m: int = 0, device=None):
        if n > base.p**base.D:
            raise ValueError(
                f"n={n} exceeds exceptional set size {base.p}^{base.D}; "
                "use ConcatRMFE"
            )
        self.device = resolve_device(device)
        self.base = base
        self.n = n
        m_req = max(2 * n - 1, min_m, 2)
        self.ext = base.extend(m_req)
        self.m = self.ext.degrees[-1]
        pts = base.exceptional_points(n)
        self.points = pts
        # phi: value vector -> coefficients of the interpolating poly (deg < n), (n, n, D)
        self.M_phi = from_numpy(as_u32(s_lagrange_coeff_matrix(base, pts)), base, self.device)
        # psi: tower coefficients -> evaluations at the n points, (n, m, D)
        self.V_psi = from_numpy(as_u32(s_vandermonde(base, pts, self.m)), base, self.device)

    def phi(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n, baseD) -> (..., extD)."""
        base, ext = self.base, self.ext
        batch = x.shape[:-2]
        flat = x.reshape((-1, self.n, base.D)).movedim(0, 1)  # (n, B, D)
        coeffs = base.matmul(self.M_phi, flat)  # (n, B, D)
        B = coeffs.shape[1]
        tower = torch.zeros((B, self.m, base.D), dtype=base.dtype, device=x.device)
        tower[:, : self.n, :] = coeffs.movedim(0, 1)
        return ext.from_tower_coeffs(tower).reshape(batch + (ext.D,))

    def psi(self, g: torch.Tensor) -> torch.Tensor:
        """g: (..., extD) -> (..., n, baseD)."""
        base, ext = self.base, self.ext
        batch = g.shape[:-1]
        tower = ext.tower_coeffs(g.reshape((-1, ext.D)), base).movedim(0, 1)  # (m, B, D)
        vals = base.matmul(self.V_psi, tower).movedim(0, 1)  # (B, n, D)
        return vals.reshape(batch + (self.n, base.D))


class ConcatRMFE:
    """(n1*n2, m1*m2)-RMFE via Lemma II.5 concatenation."""

    def __init__(self, base: Ring, n2: int, n1: int, device=None):
        self.inner = BasicRMFE(base, n2, device=device)
        self.outer = BasicRMFE(self.inner.ext, n1, device=device)
        self.base = base
        self.ext = self.outer.ext
        self.n = n1 * n2
        self.n1, self.n2 = n1, n2
        self.m = self.inner.m * self.outer.m

    def phi(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n1*n2, baseD) -> (..., extD)."""
        batch = x.shape[:-2]
        xs = x.reshape(batch + (self.n1, self.n2, self.base.D))
        return self.outer.phi(self.inner.phi(xs))

    def psi(self, g: torch.Tensor) -> torch.Tensor:
        xs = self.inner.psi(self.outer.psi(g))  # (..., n1, n2, baseD)
        return xs.reshape(g.shape[:-1] + (self.n, self.base.D))


def build_rmfe(base: Ring, n: int, min_m: int = 0, device=None):
    """Choose a Basic or Concat RMFE automatically for batch size n."""
    if n <= base.p**base.D:
        return BasicRMFE(base, n, min_m=min_m, device=device)
    # factor n = n2 * n1 with n2 <= |T(base)|
    n2 = base.p**base.D
    n1 = -(-n // n2)
    return ConcatRMFE(base, n2, n1, device=device)
