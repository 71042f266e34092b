"""Affine camera self-calibration (orthographic, symmetric-affine and
paraperspective metric upgrades).

Counterpart of ``mvrecon_tpu/models/affine.py``: observations are a dense
(F, P, 2) tensor, the constraint matrix of each camera model is one
fourth-moment quadratic form ``sum_f V^T C V`` (``ops/moments.py``) that
differs between the models only in the (3, 3) coefficient matrix C, the
symmetric 6x6 system is solved by ``eigh`` (smallest eigenvalue) or, for
the orthographic model, a linear solve, and the rotations are recovered
in one batched pass.

Every function takes leading scene dimensions ``...``, so a batch of
scenes (``parallel/batched.py``) runs through the same code as one scene.
Where the reference crashes (the metric matrix T not positive definite
under noise), the result here is NaN, flagged by
:func:`affine_self_calibration_full`; non-finite observations give NaN
for that scene only (``ops.linalg.svd``).
"""

from __future__ import annotations

import torch

from ..config import as_tensor, resolve_device, result_dtype
from ..ops.linalg import det3x3, min_eigvec_sym, orthonormalize, pinv, svd
from ..ops.moments import fourth_moment_matrix, sym_expand, sym_reduce


def observation_matrix(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered observation matrix W (..., 2F, P) with per-image centroids
    t (..., F, 2). Row 2i holds the x-coordinates of image i, row 2i + 1
    its y-coordinates."""
    nf, npts = x.shape[-3], x.shape[-2]
    t = x.mean(dim=-2)
    centered = x - t[..., None, :]
    w = centered.transpose(-1, -2).reshape(x.shape[:-3] + (2 * nf, npts))
    return w, t


def _outer_basis(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    """Per-image symmetric outer-product basis V (..., F, 3, 9): rows are
    flattened u0 u0^T, u1 u1^T, u0 u1^T + u1 u0^T."""
    s00 = u0[..., :, None] * u0[..., None, :]
    s11 = u1[..., :, None] * u1[..., None, :]
    s01 = u0[..., :, None] * u1[..., None, :]
    v = torch.stack([s00, s11, s01 + s01.transpose(-1, -2)], dim=-3)
    return v.reshape(v.shape[:-2] + (9,))


def _coeff_orthographic(t: torch.Tensor, f: torch.Tensor | None) -> torch.Tensor:
    """C = diag(1, 1, 1/4)."""
    c = torch.diag(torch.tensor([1.0, 1.0, 0.25], dtype=t.dtype, device=t.device))
    return c.expand(t.shape[:-1] + (3, 3))


def _coeff_symmetric(t: torch.Tensor, f: torch.Tensor | None) -> torch.Tensor:
    """Rank-1 C = w w^T with w = (a, -a, -c/2), a = tx ty, c = tx^2 - ty^2."""
    a = t[..., 0] * t[..., 1]
    c = t[..., 0] ** 2 - t[..., 1] ** 2
    w = torch.stack([a, -a, -0.5 * c], dim=-1)
    return w[..., :, None] * w[..., None, :]


def _coeff_paraperspective(t: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Paraperspective C in the basis (S00, S11, S01 + S10), with
    alpha = 1/(1 + tx^2/f^2), beta = 1/(1 + ty^2/f^2), gamma = tx ty/f^2:

        [[(g^2+1) a^2, (g^2-1) a b, -a g],
         [(g^2-1) a b, (g^2+1) b^2, -b g],
         [-a g,        -b g,         1  ]]
    """
    f2 = f**2
    alpha = 1.0 / (1.0 + t[..., 0] ** 2 / f2)
    beta = 1.0 / (1.0 + t[..., 1] ** 2 / f2)
    gamma = t[..., 0] * t[..., 1] / f2
    g2 = gamma**2
    one = torch.ones_like(alpha)
    return torch.stack(
        [
            torch.stack([(g2 + 1) * alpha**2, (g2 - 1) * alpha * beta, -alpha * gamma], dim=-1),
            torch.stack([(g2 - 1) * alpha * beta, (g2 + 1) * beta**2, -beta * gamma], dim=-1),
            torch.stack([-alpha * gamma, -beta * gamma, one], dim=-1),
        ],
        dim=-2,
    )


_COEFFS = {
    "orthographic": _coeff_orthographic,
    "symmetric": _coeff_symmetric,
    "paraperspective": _coeff_paraperspective,
}


def _zeta_beta_g(u0: torch.Tensor, u1: torch.Tensor, T: torch.Tensor, t: torch.Tensor):
    """Per-image zeta, beta, g for the rotation recovery, with the
    reference's degenerate-case clamps: beta^2 < 0 -> 0; |t| ~ 0 ->
    beta = 0 and zeta^-2 = (Q0 + Q2)/2; zeta^-2 <= 0 -> 1e8."""
    col0 = torch.tensor([1.0, 1.0, 0.0], dtype=t.dtype, device=t.device).expand(
        t.shape[:-1] + (3,))
    col1 = torch.stack([t[..., 0] ** 2, t[..., 1] ** 2, t[..., 0] * t[..., 1]], dim=-1)
    P = torch.stack([col0, col1], dim=-1)  # (..., F, 3, 2)

    q0 = torch.einsum("...fi,...ij,...fj->...f", u0, T, u0)
    q1 = torch.einsum("...fi,...ij,...fj->...f", u0, T, u1)
    q2 = torch.einsum("...fi,...ij,...fj->...f", u1, T, u1)
    Q = torch.stack([q0, q1, q2], dim=-1)  # (..., F, 3)

    sol = torch.einsum("...fij,...fj->...fi", pinv(P), Q)  # (..., F, 2)
    zeta2_inv, beta2 = sol[..., 0], sol[..., 1]

    beta2 = torch.where(beta2 < 0.0, 0.0, beta2)
    degenerate = (torch.abs(t) < 1e-8).all(dim=-1)
    beta2 = torch.where(degenerate, 0.0, beta2)
    zeta2_inv = torch.where(degenerate, (q0 + q2) / 2.0, zeta2_inv)
    zeta2_inv = torch.where(zeta2_inv <= 0.0, 1e8, zeta2_inv)

    zeta = torch.sqrt(1.0 / zeta2_inv)
    beta = torch.sqrt(beta2)
    return zeta, beta, zeta[..., None] * t


def _rotation_from_motion(M: torch.Tensor, u0: torch.Tensor, u1: torch.Tensor, T: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """Per-image rotations (..., F, 3, 3) from the metric motion matrix M
    (..., 2F, 3). As in the reference, the r3 normalizer uses image 0's
    ||g||^2 for every image."""
    zeta, beta, g = _zeta_beta_g(u0, u1, T, t)

    m1 = M[..., 0::2, :]  # (..., F, 3)
    m2 = M[..., 1::2, :]
    mblk = M.reshape(M.shape[:-2] + (-1, 2, 3))

    r3_denom = (zeta[..., None] * torch.linalg.cross(m1, m2, dim=-1)
                - beta[..., None] * torch.einsum("...fa,...fai->...fi", g, mblk))
    g0_sq = torch.sum(g[..., 0, :] * g[..., 0, :], dim=-1)
    r3 = r3_denom / (1.0 + beta[..., None] ** 2 * g0_sq[..., None, None])

    r1 = zeta[..., None] * m1 + (beta * g[..., 0])[..., None] * r3
    r2 = zeta[..., None] * m2 + (beta * g[..., 1])[..., None] * r3
    return orthonormalize(torch.stack([r1, r2, r3], dim=-1))  # columns r1, r2, r3


def _cholesky_or_nan(T: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each (..., n, n) matrix, all NaN where T
    is not positive definite (XLA's Cholesky gives NaN there; torch's
    raises)."""
    A, info = torch.linalg.cholesky_ex(T)
    return torch.where((info == 0)[..., None, None], A, torch.full_like(A, float("nan")))


def metric_upgrade_from_subspace(u_: torch.Tensor, t: torch.Tensor, model: str,
                                 f: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Metric upgrade and rotation recovery from the rank-3 left subspace
    ``u_`` (..., 2F, 3) of W (any orthonormal basis of that span) and the
    per-image centroids ``t`` (..., F, 2). Returns (A, R): the upgrading
    factor (the Cholesky factor of the metric matrix T) and the per-image
    rotations (..., F, 3, 3)."""
    u0, u1 = u_[..., 0::2, :], u_[..., 1::2, :]
    basis = _outer_basis(u0, u1)
    coeff = _COEFFS[model](t, f)
    b6 = sym_reduce(fourth_moment_matrix(basis, coeff), 3)

    if model == "orthographic":
        rhs = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=u_.dtype, device=u_.device)
        tau = torch.linalg.solve_ex(b6, rhs.expand(b6.shape[:-1])[..., None])[0][..., 0]
    else:
        tau = min_eigvec_sym(b6)[1]

    T = sym_expand(tau, 3)
    T = torch.where((det3x3(T) < 0)[..., None, None], -T, T)

    A = _cholesky_or_nan(T)
    R = _rotation_from_motion(u_ @ A, u0, u1, T, t)
    return A, R


def affine_self_calibration(x, model: str = "paraperspective", f=None,
                            canonical_signs: bool = False, device=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine self-calibration of observations x (..., F, P, 2). Returns
    (S, R): shape S (..., P, 3) and per-image rotations R (..., F, 3, 3).
    ``f`` (..., F) focal lengths are required for the paraperspective
    model.

    ``canonical_signs``: the reconstruction depends on the SVD's sign of
    each subspace column (flipping one flips a shape axis and can mirror
    the solution). By default the backend's signs are kept; True pins each
    column so that the first point's shape coordinate is non-negative, a
    convention independent of the backend. Runs on the card unless
    ``device`` says otherwise; the working dtype is x's."""
    if model not in _COEFFS:
        raise ValueError(f"unknown affine model: {model}")
    if model == "paraperspective" and f is None:
        raise ValueError("paraperspective model requires focal lengths f")
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))

    w, t = observation_matrix(x)
    u, sigma, vt = svd(w)
    u_ = u[..., :3]
    vt3 = vt[..., :3, :]
    if canonical_signs:
        d = torch.where(vt3[..., :, 0] < 0, -1.0, 1.0).to(x.dtype)  # (..., 3)
        u_ = u_ * d[..., None, :]
        vt3 = vt3 * d[..., :, None]

    if f is not None:
        f = as_tensor(f, dev, x.dtype)
    A, R = metric_upgrade_from_subspace(u_, t, model, f)
    S = torch.linalg.solve_triangular(A, sigma[..., :3, None] * vt3, upper=False)
    return S.transpose(-1, -2), R


def affine_self_calibration_full(x, model: str = "paraperspective", f=None, device=None
                                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`affine_self_calibration` plus a per-scene ``ok`` flag: False
    where the metric matrix was not positive definite or the observations
    were not finite, so S and R hold NaN (the reference crashes in its
    Cholesky there)."""
    s, r = affine_self_calibration(x, model=model, f=f, device=device)
    ok = torch.isfinite(s).all(dim=-1).all(dim=-1) & torch.isfinite(r).flatten(-3).all(dim=-1)
    return s, r, ok


def orthographic_self_calibration(x, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthographic metric upgrade."""
    return affine_self_calibration(x, model="orthographic", device=device)


def symmetric_affine_self_calibration(x, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric-affine metric upgrade."""
    return affine_self_calibration(x, model="symmetric", device=device)


def paraperspective_self_calibration(x, f, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Paraperspective metric upgrade with focal lengths f (..., F)."""
    return affine_self_calibration(x, model="paraperspective", f=f, device=device)
