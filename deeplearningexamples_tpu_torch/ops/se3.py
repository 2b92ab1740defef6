"""Port of ``deeplearningexamples_tpu/ops/se3.py``: the SE(3)-equivariant
basis, real spherical harmonics and Clebsch-Gordan coefficients.

The reference SE3Transformer's basis (``DGLPyTorch/DrugDiscovery/
SE3Transformer/se3_transformer/model/basis.py``) calls e3nn's
``o3.spherical_harmonics`` and ``o3.wigner_3j``; JAX derives both from first
principles, and so does the port:

- real spherical harmonics by the associated-Legendre recursion
  (Condon-Shortley), in torch: ``sin`` is ``sqrt(clip(1 - z^2, 1e-12))``
  (the sqrt's infinite derivative at 0 would make a pole-aligned or zero
  relative position give NaN gradients), the unit vector ``vec / max(r,
  1e-12)``, and a zero vector's azimuth ``atan2(0, 0) = 0`` (its values are
  finite; the trunk masks the self-edges that have them);
- Clebsch-Gordan coefficients from Racah's closed form with exact integer
  factorials, and the real-basis intertwiners Q^J_{(d_in, d_out)} from the
  complex ones conjugated by the complex-to-real change of basis: a numpy
  copy of JAX's ``_cg_complex``, ``_real_basis_u`` and
  ``clebsch_gordan_real`` (cached), so the coefficients are JAX's bit for
  bit;
- ``se3_basis``: the reference's ``get_basis`` contract, basis['{d_in},
  {d_out}'] of shape (..., 2 d_in + 1, n_freq, 2 d_out + 1), n_freq = 2
  min(d_in, d_out) + 1, each frequency J the einsum of Y_J with Q_J
  (equation (8) of the SE(3)-Transformer paper).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["clebsch_gordan_real", "degree_to_dim", "real_spherical_harmonics",
           "se3_basis"]


def degree_to_dim(d: int) -> int:
    return 2 * d + 1


def _assoc_legendre(l_max: int, z: torch.Tensor, one_minus_z2: torch.Tensor
                    ) -> dict:
    """P_l^m(z) for 0 <= m <= l <= l_max with the Condon-Shortley phase:
    (l, m) -> tensor. ``one_minus_z2`` = 1 - z^2 (= sin^2)."""
    p = {(0, 0): torch.ones_like(z)}
    sin_t = torch.sqrt(one_minus_z2.clamp_min(1e-12))
    for m in range(1, l_max + 1):
        # P_m^m = (-1)^m (2m-1)!! sin^m
        p[(m, m)] = (-1) ** m * math.prod(range(1, 2 * m, 2)) * sin_t ** m
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * z * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = ((2 * l - 1) * z * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    return p


def real_spherical_harmonics(vec: torch.Tensor, l_max: int
                             ) -> list[torch.Tensor]:
    """Real SH of unit(vec) for l = 0..l_max: vec (..., 3) -> [(..., 2l+1)],
    m = -l..l:

      m < 0: (-1)^m sqrt(2) N_{l|m|} P_l^{|m|}(cos t) sin(|m| phi)
      m = 0: N_{l0} P_l^0(cos t)
      m > 0: (-1)^m sqrt(2) N_{lm} P_l^m(cos t) cos(m phi)

    with N_lm = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!)."""
    r = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    unit = vec / r.clamp_min(1e-12)
    x, y, z = unit.unbind(-1)
    phi = torch.atan2(y, x)
    p = _assoc_legendre(l_max, z, x * x + y * y)
    out = []
    for l in range(l_max + 1):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            n = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            if m == 0:
                cols.append(n * p[(l, 0)])
            elif m > 0:
                cols.append((-1) ** m * math.sqrt(2) * n * p[(l, m)]
                            * torch.cos(m * phi))
            else:
                cols.append((-1) ** am * math.sqrt(2) * n * p[(l, am)]
                            * torch.sin(am * phi))
        out.append(torch.stack(cols, -1))
    return out


def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """Copy of ``deeplearningexamples_tpu/ops/se3.py``'s ``_cg_complex``:
    <l1 m1 l2 m2 | l3 m3> by Racah's formula (exact integer factorials), as
    (2 l3 + 1, 2 l1 + 1, 2 l2 + 1) indexed [m3, m1, m2]."""
    f = math.factorial
    out = np.zeros((2 * l3 + 1, 2 * l1 + 1, 2 * l2 + 1))
    pref_sq = (2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2) \
        * f(l1 + l2 - l3) / f(l1 + l2 + l3 + 1)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            s_sq = f(l3 + m3) * f(l3 - m3) * f(l1 - m1) * f(l1 + m1) \
                * f(l2 - m2) * f(l2 + m2)
            total = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                denoms = (k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                          l3 - l2 + m1 + k, l3 - l1 - m2 + k)
                if any(d < 0 for d in denoms):
                    continue
                total += (-1) ** k / math.prod(f(d) for d in denoms)
            out[m3 + l3, m1 + l1, m2 + l2] = \
                math.sqrt(pref_sq * s_sq) * total
    return out


def _real_basis_u(l: int) -> np.ndarray:
    """Copy of JAX's ``_real_basis_u``: the unitary U_l with v_real = U_l
    v_complex (rows real m, columns complex m', both -l..l)."""
    u = np.zeros((2 * l + 1, 2 * l + 1), complex)
    u[l, l] = 1.0
    s2 = 1.0 / math.sqrt(2)
    for m in range(1, l + 1):
        u[l + m, l + m] = (-1) ** m * s2  # real cos row
        u[l + m, l - m] = s2
        u[l - m, l - m] = 1j * s2  # real sin row
        u[l - m, l + m] = -1j * (-1) ** m * s2
    return u


@lru_cache(maxsize=None)
def clebsch_gordan_real(j: int, d_in: int, d_out: int) -> np.ndarray:
    """Copy of JAX's ``clebsch_gordan_real``: the real-basis intertwiner Q
    (2j+1, 2 d_in+1, 2 d_out+1) with out[m_out] = sum Q[m_j, m_in, m_out]
    Y_j[m_j] feat_in[m_in] equivariant. The conjugated complex CG is
    purely real or purely imaginary by the parity of j + d_in + d_out; the
    part that does not vanish is taken."""
    c = _cg_complex(j, d_in, d_out)  # [m_out, m_j, m_in]
    u_out = _real_basis_u(d_out)
    u_j = np.conj(_real_basis_u(j))
    u_in = np.conj(_real_basis_u(d_in))
    cr = np.einsum("Mm,mjk,Jj,Kk->MJK", u_out, c, u_j, u_in)
    re, im = np.real(cr), np.imag(cr)
    if np.abs(im).max() > np.abs(re).max():
        assert np.abs(re).max() < 1e-10, (j, d_in, d_out)
        q = im
    else:
        assert np.abs(im).max() < 1e-10, (j, d_in, d_out)
        q = re
    return np.ascontiguousarray(q.transpose(1, 2, 0))  # [m_j, m_in, m_out]


def se3_basis(rel_pos: torch.Tensor, max_degree: int) -> dict:
    """Pairwise equivariant bases (reference ``get_basis``): rel_pos (...,
    3) -> {'{d_in},{d_out}': (..., 2 d_in + 1, n_freq, 2 d_out + 1)}, the
    frequency J from |d_in - d_out| to d_in + d_out."""
    sh = real_spherical_harmonics(rel_pos, 2 * max_degree)
    basis = {}
    for d_in in range(max_degree + 1):
        for d_out in range(max_degree + 1):
            ks = []
            for j in range(abs(d_in - d_out), d_in + d_out + 1):
                q = torch.as_tensor(clebsch_gordan_real(j, d_in, d_out),
                                    dtype=sh[0].dtype, device=sh[0].device)
                ks.append(torch.einsum("...j,jik->...ik", sh[j], q))
            basis[f"{d_in},{d_out}"] = torch.stack(ks, -2)
    return basis
