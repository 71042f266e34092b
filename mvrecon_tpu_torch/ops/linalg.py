"""Small-matrix linear algebra: batched ``eigh`` and ``svd`` that isolate
non-finite matrices, the closed-form 3x3 inverse, determinant and
Cholesky, the lower-triangular inverse, the blocked 9x9 Cholesky and SPD
inverse, the pseudo-inverse, the smallest eigenvector of a symmetric
matrix, and the nearest-orthogonal (polar) factor.

Counterpart of ``mvrecon_tpu/ops/linalg.py``. The JAX package's Jacobi
eigensolver exists only because small batched ``eigh`` is slow on a TPU;
here ``torch.linalg.eigh`` takes its place, through :func:`eigh`.

``torch.linalg.eigh`` and ``torch.linalg.svd`` raise for a whole batch
when one matrix in it is not finite, where XLA's decompositions return
NaN for that matrix alone. Every batched decomposition of the port goes
through :func:`eigh` or :func:`svd`, which decompose a finite placeholder
in place of each non-finite matrix and write NaN into its outputs, so one
poisoned scene of a batch ends non-finite and flags itself while the
others are untouched.
"""

from __future__ import annotations

import torch

# Matrices per batched ``torch.linalg.eigh`` call. On the card, cuSOLVER's
# batched eigensolver (torch 2.11, CUDA 12.8, H100) takes 24,576 4x4 or
# 12x12 matrices and refuses 32,768 with CUSOLVER_STATUS_INVALID_VALUE from
# its workspace query (scripts/eigh_batch_limit.py).
EIGH_BATCH = 16384


def _finite_or_placeholder(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(a with each non-finite (..., m, n) matrix replaced by the identity's
    leading block, the (...,) mask of finite matrices)."""
    ok = torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-2], a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.where(ok[..., None, None], a, eye), ok


def _nan_where_not(ok: torch.Tensor, out: torch.Tensor, core_dims: int) -> torch.Tensor:
    """``out`` with NaN in every batch entry where ``ok`` is False."""
    mask = ok.reshape(ok.shape + (1,) * core_dims)
    return torch.where(mask, out, torch.full_like(out, float("nan")))


def eigh(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of (..., n, n) symmetric matrices (ascending
    eigenvalues), in slices of at most ``EIGH_BATCH`` matrices. A matrix
    with a non-finite entry gets all-NaN eigenvalues and eigenvectors; the
    others are decomposed as if alone."""
    a, ok = _finite_or_placeholder(a)
    flat = a.reshape((-1,) + a.shape[-2:])
    if flat.shape[0] <= EIGH_BATCH:
        w, v = torch.linalg.eigh(a)
    else:
        parts = [torch.linalg.eigh(m) for m in flat.split(EIGH_BATCH)]
        w = torch.cat([p[0] for p in parts]).reshape(a.shape[:-1])
        v = torch.cat([p[1] for p in parts]).reshape(a.shape)
    return _nan_where_not(ok, w, 1), _nan_where_not(ok, v, 2)


def svd(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduced ``torch.linalg.svd`` (U, S, Vh) of (..., m, n) matrices. A
    matrix with a non-finite entry gets all-NaN factors; the others are
    decomposed as if alone."""
    a, ok = _finite_or_placeholder(a)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return _nan_where_not(ok, u, 2), _nan_where_not(ok, s, 1), _nan_where_not(ok, vh, 2)


def pinv(a: torch.Tensor) -> torch.Tensor:
    """Moore–Penrose pseudo-inverse of (..., m, n) matrices through
    :func:`svd`, with ``jnp.linalg.pinv``'s cutoff: singular values at or
    below 10 max(m, n) eps times the largest are dropped."""
    u, s, vh = svd(a)
    rcond = 10.0 * max(a.shape[-2:]) * torch.finfo(a.dtype).eps
    keep = s > rcond * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    return torch.einsum("...ki,...k,...jk->...ij", vh, s_inv, u)


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


def solve3x3(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 3, 3) @ x = (..., 3) through the adjugate inverse."""
    return torch.einsum("...ij,...j->...i", inv3x3(m), b)


def min_eigvec_sym(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalue, eigenvector) of the smallest eigenvalue of a symmetric
    matrix (``eigh`` sorts ascending)."""
    w, v = eigh(a)
    return w[..., 0], v[..., :, 0]


def max_eigvec_sym(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalue, eigenvector) of the largest eigenvalue of a symmetric
    matrix."""
    w, v = eigh(a)
    return w[..., -1], v[..., :, -1]


def orthonormalize(r: torch.Tensor) -> torch.Tensor:
    """Nearest orthogonal matrix to each (..., 3, 3) matrix: the SVD polar
    factor U V^T, computed by :func:`polar_orthogonal3`."""
    return polar_orthogonal3(r)


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
    w, v = eigh(g)  # ascending
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


def solve_lower3(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b for (..., 3, 3) lower-triangular L and
    (..., 3, N) right-hand sides."""
    y0 = b[..., 0, :] / l[..., 0, 0, None]
    y1 = (b[..., 1, :] - l[..., 1, 0, None] * y0) / l[..., 1, 1, None]
    y2 = (b[..., 2, :] - l[..., 2, 0, None] * y0 - l[..., 2, 1, None] * y1) / l[..., 2, 2, None]
    return torch.stack([y0, y1, y2], dim=-2)


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


def _block3(rows) -> torch.Tensor:
    """(..., 9, 9) from a 3x3 nest of (..., 3, 3) blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _abt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T over (..., 3, 3) batches."""
    return a @ b.transpose(-1, -2)


def chol9_blocks(g: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky factor L (lower) of (..., 9, 9) SPD matrices by
    3x3-blocked elimination. The block products run in full precision (a
    float32 product on the card must not drop to TF32): the Schur
    subtractions D - L21 L21^T cancel almost completely for ill-conditioned
    blocks, and a reduced-precision product there makes the remainder
    indefinite, so sqrt(negative) gives NaN."""
    A, B, C = g[..., 0:3, 0:3], g[..., 3:6, 0:3], g[..., 6:9, 0:3]
    D, E, F = g[..., 3:6, 3:6], g[..., 6:9, 3:6], g[..., 6:9, 6:9]
    l11 = chol3x3(A)
    i11 = inv_lower3(l11)
    l21 = _abt(B, i11)  # B L11^-T
    l31 = _abt(C, i11)
    l22 = chol3x3(D - _abt(l21, l21))
    l32 = _abt(E - _abt(l31, l21), inv_lower3(l22))
    l33 = chol3x3(F - _abt(l31, l31) - _abt(l32, l32))
    z = torch.zeros_like(l11)
    return _block3([[l11, z, z], [l21, l22, z], [l31, l32, l33]])


def inv9_spd(g: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 9, 9) SPD matrices (the damped BA camera
    blocks): blocked Cholesky, blocked triangular inverse, G^-1 = L^-T L^-1."""
    l = chol9_blocks(g)
    i11 = inv_lower3(l[..., 0:3, 0:3])
    i22 = inv_lower3(l[..., 3:6, 3:6])
    i33 = inv_lower3(l[..., 6:9, 6:9])
    l21, l31, l32 = l[..., 3:6, 0:3], l[..., 6:9, 0:3], l[..., 6:9, 3:6]
    m21 = -(i22 @ l21 @ i11)
    m32 = -(i33 @ l32 @ i22)
    m31 = -(i33 @ (l31 @ i11 + l32 @ m21))
    z = torch.zeros_like(i11)
    linv = _block3([[i11, z, z], [m21, i22, z], [m31, m32, i33]])
    return linv.transpose(-1, -2) @ linv


def blockdiag_scatter(blocks: torch.Tensor) -> torch.Tensor:
    """(F, K, K) blocks -> the (F K, F K) block-diagonal matrix."""
    nf, k, _ = blocks.shape
    eye_f = torch.eye(nf, dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("fg,fkl->fkgl", eye_f, blocks).reshape(nf * k, nf * k)
