"""Small-matrix linear algebra: closed-form 3x3 inverse, determinant and
Cholesky, the lower-triangular inverse, the smallest eigenvector of a
symmetric matrix, and the nearest-orthogonal (polar) factor.

Counterpart of ``mvrecon_tpu/ops/linalg.py``. The JAX package's Jacobi
eigensolver exists only because small batched ``eigh`` is slow on a TPU;
here ``torch.linalg.eigh`` takes its place.
"""

from __future__ import annotations

import torch


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d

    inv_det = 1.0 / (a * A + b * B + c * C)
    adj = torch.stack(
        [
            torch.stack([A, D, G], dim=-1),
            torch.stack([B, E, H], dim=-1),
            torch.stack([C, F, I], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def min_eigvec_sym(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalue, eigenvector) of the smallest eigenvalue of a symmetric
    matrix (``eigh`` sorts ascending)."""
    w, v = torch.linalg.eigh(a)
    return w[..., 0], v[..., :, 0]


def _unit_or(x: torch.Tensor, fallback: torch.Tensor, tiny: float) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    ok = n > tiny**0.5
    return torch.where(ok, x / torch.where(ok, n, torch.ones_like(n)), fallback)


def polar_orthogonal3(a: torch.Tensor) -> torch.Tensor:
    """Nearest orthogonal factor of (..., 3, 3) matrices as
    A (A^T A)^{-1/2} (the SVD polar factor U V^T for nonsingular A, det
    sign kept). Where A is numerically rank-deficient the null directions
    are completed by cross products of the healthy left vectors, as in the
    JAX package."""
    dt = a.dtype
    eps = torch.finfo(dt).eps
    tiny = torch.finfo(dt).tiny
    g = torch.einsum("...ji,...jk->...ik", a, a)
    w, v = torch.linalg.eigh(g)  # ascending
    wc = w.clamp_min(tiny)
    inv_sqrt = torch.einsum("...ik,...k,...jk->...ij", v, 1.0 / torch.sqrt(wc), v)
    direct = a @ inv_sqrt

    # forming A^T A leaves absolute noise ~eps * w_max in every entry, so a
    # zero singular value shows up as w_0 ~ eps * w_max
    healthy = w[..., 0] > 32.0 * eps * w[..., 2]

    av = torch.einsum("...ij,...jk->...ik", a, v)  # A v_k columns
    e_z = torch.zeros_like(av[..., 2])
    e_z[..., 2] = 1.0
    u2 = _unit_or(av[..., 2], e_z, tiny)  # largest direction (zero A -> e_z)
    idx = torch.argmin(torch.abs(u2), dim=-1)
    e_min = torch.nn.functional.one_hot(idx, 3).to(dt)
    alt1 = e_min - torch.sum(e_min * u2, dim=-1, keepdim=True) * u2
    cand1 = av[..., 1] - torch.sum(av[..., 1] * u2, dim=-1, keepdim=True) * u2
    u1 = _unit_or(cand1, _unit_or(alt1, e_min, tiny), tiny)
    u0 = torch.linalg.cross(u2, u1)
    u_cols = torch.stack([u0, u1, u2], dim=-1)
    completed = torch.einsum("...ik,...jk->...ij", u_cols, v)
    return torch.where(healthy[..., None, None], direct, completed)


def chol3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky factor L (lower) of (..., 3, 3) SPD matrices."""
    a11, a21, a31 = m[..., 0, 0], m[..., 1, 0], m[..., 2, 0]
    a22, a32, a33 = m[..., 1, 1], m[..., 2, 1], m[..., 2, 2]
    l11 = torch.sqrt(a11)
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(a33 - l31 * l31 - l32 * l32)
    z = torch.zeros_like(l11)
    return torch.stack(
        [
            torch.stack([l11, z, z], dim=-1),
            torch.stack([l21, l22, z], dim=-1),
            torch.stack([l31, l32, l33], dim=-1),
        ],
        dim=-2,
    )


def inv_lower3(l: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) lower-triangular matrices."""
    i11 = 1.0 / l[..., 0, 0]
    i22 = 1.0 / l[..., 1, 1]
    i33 = 1.0 / l[..., 2, 2]
    i21 = -l[..., 1, 0] * i11 * i22
    i31 = (l[..., 1, 0] * l[..., 2, 1] - l[..., 2, 0] * l[..., 1, 1]) * i11 * i22 * i33
    i32 = -l[..., 2, 1] * i22 * i33
    z = torch.zeros_like(i11)
    return torch.stack(
        [
            torch.stack([i11, z, z], dim=-1),
            torch.stack([i21, i22, z], dim=-1),
            torch.stack([i31, i32, i33], dim=-1),
        ],
        dim=-2,
    )
