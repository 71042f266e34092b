"""Levenberg–Marquardt bundle adjustment with point-block Schur elimination.

Counterpart of ``mvrecon_tpu/models/bundle_adjustment.py``: the state and
result tuples, the 7-DoF gauge (camera-0 pose plus one baseline component,
kept as a mask over the full 9F parameter vector), the projective-scale K
normalization (``intrinsics_from_K``, docs/PARITY.md #6), the homogeneous
projection (p, q, r), the derivative blocks, the damped Schur solve from
either side, and the dense LM core (``lm_step``, ``lm_optimize``,
``bundle_adjust``). The chunked and streamed cores build on the pieces
here.

Every function takes leading scene dimensions ``...``: one problem is the
case with none, and S problems of one shape run as lanes
(``parallel/batched.py``), which is what ``vmap`` makes of the JAX
functions. The JAX loops are ``lax.while_loop``s inside one ``jit``; here
they are Python loops that read from the card once per retry whether any
lane is still retrying and whether any will iterate again. A lane that has
accepted its trial, or finished, keeps its state, damping and count by
``torch.where`` while the others go on. A damped system that is not
positive definite gives a NaN step, which rejects the trial and raises the
damping, as ``cho_factor``'s NaNs do there. Every sum over points is a
contraction inside one ``einsum`` or matrix product, so no (P, F, 9, 9)
block is ever formed.

Robust losses (``LMConfig.robust``: huber, cauchy, soft_l1, arctan) run as
IRLS: each outer iteration reweights every observation from its current
residual, per lane.

Six lens distortion families are ported: BAL radial (k1, k2), OPENCV
(k1, k2, p1, p2), OPENCV_FISHEYE (k1..k4), full OPENCV (the rational
k1..k6 with p1, p2), FOV (one angle) and THIN_PRISM_FISHEYE. The residuals
and the rank-2 Jacobian factors chain through the model's exact 2x2
Jacobian (:func:`_apply_distortion_chain`, asymmetric for thin prism), so
every downstream Schur path is unchanged; ``distortion_rounds`` alternates
a refit of the model (:func:`fit_distortion`: closed form, or the
full-OPENCV alternation, or Gauss-Newton on the FOV angle) with the
geometry LM. :func:`distort_points` and :func:`undistort_points` map
image points through the model and back. Distortion is for one problem,
not for lanes.

Under ``axis_name`` (one problem whose points are split over the ranks of
a mesh axis, ``parallel/sharded_ba.py``) every camera-side sum over points
is all-reduced where the JAX package ``psum``s it (:func:`_psum`): E, d_F
and matG of the derivative build, the Schur product and its rhs, the
point side of the gain ratio, every trial E and the refit's normal
terms. Every branch of the loop then reads only all-reduced or replicated
values, so all ranks take it together. ``lm_optimize``'s ``solver`` hook
replaces the damped solve of the retries: the 2D BA
(``parallel/sharded_ba_2d.py``) plugs its row-sharded CG in there.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..ops.lanes import keep, keep_all, lane_view
from ..ops.linalg import chol3x3, inv3x3, inv9_spd, inv_lower3
from ..ops.rotations import rodrigues
from ..ops.syrk import row_stride


class BAState(NamedTuple):
    """Optimizable parameters (normalized gauge frame), with optional
    leading lane dimensions."""

    X: torch.Tensor  # (..., P, 3)
    f: torch.Tensor  # (..., F)
    u: torch.Tensor  # (..., F, 2)
    t: torch.Tensor  # (..., F, 3)
    R: torch.Tensor  # (..., F, 3, 3)


class BAResult(NamedTuple):
    X: torch.Tensor  # (..., P, 3) in the original (global) frame
    K: torch.Tensor  # (..., F, 3, 3)
    R: torch.Tensor  # (..., F, 3, 3)
    t: torch.Tensor  # (..., F, 3)
    error: torch.Tensor  # (...,) final reprojection error E (sum of squares)
    n_iter: int | torch.Tensor  # an int for one problem, (...,) for lanes
    log: dict | None
    distortion: torch.Tensor | None = None


AXIS_MODES = ("x-right_z-forward", "x-up_z-forward")


def _axis_index(axis: str) -> int:
    """0 for x-right (baseline component t1_x), 1 for x-up (t1_y)."""
    if axis not in AXIS_MODES:
        raise ValueError(f"unknown axis mode: {axis}")
    return AXIS_MODES.index(axis)


def gauge_mask(n_images: int, axis: str, dtype, device=None) -> torch.Tensor:
    """(9F,) mask: 0 at the 7 gauge-fixed camera parameters (camera-0 t
    and omega, one component of t1), 1 elsewhere."""
    ax = _axis_index(axis)
    mask = torch.ones(9 * n_images, dtype=dtype, device=device)
    mask[[3, 4, 5, 6, 7, 8, 12 + ax]] = 0
    return mask


def normalize_gauge(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor, axis: str):
    """Move the scene to camera 0 with a unit baseline component. The sign
    is taken in the camera-0 frame (the JAX package's documented deviation,
    docs/PARITY.md #5), so restore(normalize(state)) is the identity.
    Returns the normalized (X, R, t) and the restore info."""
    ax = _axis_index(axis)
    r0, t0 = R[..., 0, :, :], t[..., 0, :]
    c0c1_len = torch.abs(torch.sum(r0[..., :, ax] * (t[..., 1, :] - t0), dim=-1))
    X_ = X - t0[..., None, :]
    t_ = t - t0[..., None, :]
    s = torch.abs(torch.sum(r0[..., :, ax] * t_[..., 1, :], dim=-1))[..., None, None]
    X_ = (X_ @ r0) / s
    R_ = torch.einsum("...ji,...fjk->...fik", r0, R)
    t_ = (t_ @ r0) / s
    return X_, R_, t_, {"R0": r0, "t0": t0, "scale": c0c1_len}


def restore_gauge(info: dict, X: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Invert ``normalize_gauge``."""
    r0, t0, scale = info["R0"], info["t0"][..., None, :], info["scale"][..., None, None]
    r0t = r0.transpose(-1, -2)
    return (
        (scale * X) @ r0t + t0,
        torch.einsum("...ij,...fjk->...fik", r0, R),
        (scale * t) @ r0t + t0,
    )


def build_K(f: torch.Tensor, u: torch.Tensor, f0: float) -> torch.Tensor:
    """(..., F, 3, 3) intrinsics from f, (u0, v0), f0."""
    k = torch.zeros(f.shape + (3, 3), dtype=f.dtype, device=f.device)
    k[..., 0, 0] = f
    k[..., 1, 1] = f
    k[..., :2, 2] = u
    k[..., 2, 2] = f0
    return k


def intrinsics_from_K(K: torch.Tensor, f0: float):
    """(f, u) of ``K = [[f, 0, u0], [0, f, v0], [0, 0, f0]]`` from a
    projective-scale K: rescale to ``K[2, 2] == f0`` first (self-
    calibration returns K only up to a per-camera scale)."""
    s = f0 / K[..., 2, 2]
    return K[..., 0, 0] * s, K[..., :2, 2] * s[..., None]


def calc_pqr(X: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Camera matrices P (..., F, 3, 4) and homogeneous image coordinates
    (p, q, r), each (..., P, F)."""
    rt = R.transpose(-1, -2)
    trans = -torch.einsum("...fij,...fj->...fi", rt, t)
    pmat = K @ torch.cat([rt, trans[..., None]], dim=-1)
    pqr = torch.einsum("...fca,...pa->...pfc", pmat[..., :3], X) + pmat[..., None, :, :, 3]
    return pmat, pqr[..., 0], pqr[..., 1], pqr[..., 2]


def reprojection_error(x, p, q, r, vis, f0: float) -> torch.Tensor:
    """Sum of squared residuals E of each problem. r is sanitized where
    vis == 0 so masked or padded entries cannot produce 0 * inf."""
    r = torch.where(vis > 0, r, torch.ones_like(r))
    e = (p / r - x[..., 0] / f0) ** 2 + (q / r - x[..., 1] / f0) ** 2
    return torch.sum(vis * e, dim=(-2, -1))


def _camera_param_derivs(state: BAState, p: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                         f0: float):
    """(dp, dq, dr)/d(f, u0, v0, t, omega): (..., P, F, 9) each, for the
    points ``state.X`` (..., P, 3)."""
    f, u, t, R, X = state.f, state.u, state.t, state.R, state.X
    shape = p.shape

    # d/df
    dpdf = (p - (u[..., 0] / f0)[..., None, :] * r) / f[..., None, :]
    dqdf = (q - (u[..., 1] / f0)[..., None, :] * r) / f[..., None, :]
    zeros = torch.zeros_like(dpdf)
    # d/du
    r_over_f0 = r / f0
    # d/dt: per-image constants, broadcast
    dpdt_f = -(f[..., None] * R[..., :, 0] + u[..., :1] * R[..., :, 2])  # (..., F, 3)
    dqdt_f = -(f[..., None] * R[..., :, 1] + u[..., 1:2] * R[..., :, 2])
    drdt_f = -f0 * R[..., :, 2]
    # d/domega = cross(-d/dt, X - t)
    x_minus_t = X[..., :, None, :] - t[..., None, :, :]  # (..., P, F, 3)

    def stack(df, du0, du1, dt_f):
        out = torch.empty(shape + (9,), dtype=p.dtype, device=p.device)
        out[..., 0] = df
        out[..., 1] = du0
        out[..., 2] = du1
        out[..., 3:6] = dt_f[..., None, :, :]
        out[..., 6:9] = torch.linalg.cross(-dt_f[..., None, :, :], x_minus_t)
        return out

    return (stack(dpdf, r_over_f0, zeros, dpdt_f), stack(dqdf, zeros, r_over_f0, dqdt_f),
            stack(zeros, zeros, zeros, drdt_f))


def _chunk_factors(state_cam: BAState, X_c, x_c, vis_c, f0: float, huber_delta=None,
                   robust_kind: str = "huber", dist=None, model: str | None = None):
    """Rank-2 Jacobian factors for a set of points (all of them, or one
    chunk): every second-derivative block is 2 * vis * (a1 (x) b1 +
    a2 (x) b2), so downstream stages work from (a1, a2 (..., C, F, 3);
    b1, b2 (..., C, F, 9); residuals) without materializing the blocks they
    don't need. With ``dist`` the residuals and the factors chain through
    the distortion model (:func:`_apply_distortion_chain`). With
    ``huber_delta`` the IRLS weights of ``robust_kind`` at these (distorted)
    residuals multiply into the returned effective visibility, which is
    then (..., C, F). Returns (a1, a2, b1, b2, res_p, res_q, vis_c)."""
    st = state_cam._replace(X=X_c)
    K = build_K(st.f, st.u, f0)
    pmat, p, q, r = calc_pqr(X_c, K, st.R, st.t)

    dpdX, dqdX, drdX = (pmat[..., None, :, i, :3] for i in range(3))  # (..., 1, F, 3)
    dpdc, dqdc, drdc = _camera_param_derivs(st, p, q, r, f0)

    r = torch.where(vis_c > 0, r, torch.ones_like(r))  # 0 * inf guard (padding)
    res_p = p / r - x_c[..., 0] / f0
    res_q = q / r - x_c[..., 1] / f0

    inv_r2 = (1.0 / (r * r))[..., None]
    r_, p_, q_ = r[..., None], p[..., None], q[..., None]
    a1 = (r_ * dpdX - p_ * drdX) * inv_r2
    a2 = (r_ * dqdX - q_ * drdX) * inv_r2
    # (..., C, F, 9) planes, built in place and freed as soon as they are
    # used: the derivative planes are the largest temporaries
    b1 = dpdc.mul_(r_).sub_(p_ * drdc).mul_(inv_r2)
    del dpdc
    b2 = dqdc.mul_(r_).sub_(q_ * drdc).mul_(inv_r2)
    del dqdc, drdc
    if dist is not None:
        res_p, res_q, a1, a2, b1, b2 = _apply_distortion_chain(
            st, p, q, r, f0, dist, res_p, res_q, a1, a2, b1, b2, model)
    if huber_delta is not None:
        vis_c = vis_c * robust_weight(torch.sqrt(res_p**2 + res_q**2), huber_delta, robust_kind)
    return a1, a2, b1, b2, res_p, res_q, vis_c


def _point_grad_and_block(a1, a2, res_p, res_q, vis_c):
    """d_P (..., C, 3) and matE (..., C, 3, 3) from the factors (with the
    unseen-point identity guard), each a contraction over the camera axis."""
    vis_d = vis_c.expand(res_p.shape)
    d_P = 2.0 * (torch.einsum("...pf,...pfx->...px", vis_d * res_p, a1)
                 + torch.einsum("...pf,...pfx->...px", vis_d * res_q, a2))
    visf = vis_d[..., None]
    matE = 2.0 * (torch.einsum("...pfi,...pfj->...pij", visf * a1, a1)
                  + torch.einsum("...pfi,...pfj->...pij", visf * a2, a2))
    seen = (torch.sum(vis_d, dim=-1) > 0).to(matE.dtype)
    matE = matE + (1.0 - seen)[..., None, None] * torch.eye(3, dtype=matE.dtype,
                                                            device=matE.device)
    return d_P, matE


def _chunk_blocks(state_cam: BAState, X_c, x_c, vis_c, free, f0: float, huber_delta=None,
                  robust_kind: str = "huber", dist=None, model: str | None = None):
    """Derivative blocks for a set of C points: d_P (..., C, 3), the masked
    d_F (..., 9F), matE (..., C, 3, 3), matF (..., C, 3, 9F) with unmasked
    columns, matG (..., F, 9, 9) and the error of these points, all
    IRLS-weighted with ``huber_delta`` and through the distortion model
    with ``dist`` (:func:`_chunk_factors`).

    Each sum over points is written as a contraction over the point axis
    (a batched product over cameras), and matF is written once in place,
    so no (C, F, 9, 9) or per-term (C, 3, F, 9) temporary exists."""
    nf = state_cam.f.shape[-1]
    lead = X_c.shape[:-1]  # (..., C)
    a1, a2, b1, b2, res_p, res_q, vis_c = _chunk_factors(state_cam, X_c, x_c, vis_c, f0,
                                                         huber_delta, robust_kind, dist, model)
    vis_d = vis_c.expand(res_p.shape)
    e_chunk = torch.sum(vis_d * (res_p**2 + res_q**2), dim=(-2, -1))

    d_F = 2.0 * (torch.einsum("...pf,...pfj->...fj", vis_d * res_p, b1)
                 + torch.einsum("...pf,...pfj->...fj", vis_d * res_q, b2))
    d_F = d_F.reshape(lead[:-1] + (9 * nf,)) * free

    d_P, matE = _point_grad_and_block(a1, a2, res_p, res_q, vis_c)

    visf = vis_d[..., None]
    matG = 2.0 * (torch.einsum("...pfi,...pfj->...fij", visf * b1, b1)
                  + torch.einsum("...pfi,...pfj->...fij", visf * b2, b2))
    # matF[p, i, f, j] = 2 vis (a1[p, f, i] b1[p, f, j] + a2[p, f, i] b2[p, f, j])
    va1, va2 = (2.0 * visf) * a1, (2.0 * visf) * a2
    matF = torch.empty(lead + (3, nf, 9), dtype=b1.dtype, device=b1.device)
    for i in range(3):
        torch.mul(va1[..., i:i + 1], b1, out=matF[..., i, :, :])
        matF[..., i, :, :].addcmul_(va2[..., i:i + 1], b2)
    return d_P, d_F, matE, matF.view(lead + (3, 9 * nf)), matG, e_chunk


def _damped_schur_factor(matE, matF, d_P, c):
    """The chunk's damped Schur factors of the non-fused builds: with
    L Lᵀ = matE (1 + c diag), Y = L⁻¹F (3C, 9F) and yd = L⁻¹ d_P (C, 3),
    so that Fᵀ E_c⁻¹ F = YᵀY and Fᵀ E_c⁻¹ d_P = Yᵀ yd. Returns (Yᵀ (9F, 3C),
    yd): Yᵀ is written by the product itself in rows that start on
    128-byte lines, so its transpose Y is K-major, as K1 reads it in place.
    matF (C, 3, 9F) is not needed afterwards."""
    linv = inv_lower3(chol3x3(_damp(matE, c)))
    npts_c, _, nf9 = matF.shape
    y_t = torch.empty((nf9, row_stride(npts_c * 3)), dtype=matF.dtype,
                      device=matF.device)[:, :npts_c * 3]
    torch.bmm(matF.transpose(1, 2), linv.transpose(1, 2),
              out=y_t.view(nf9, npts_c, 3).transpose(0, 1))
    return y_t, torch.einsum("pxy,py->px", linv, d_P)


def _chunk_backsub(cam: BAState, trial_cam: BAState, X_c, x_c, vis_c, free, c, delta_xi,
                   f0: float, huber_delta=None, robust_kind: str = "huber", dist=None,
                   model: str | None = None):
    """Back-substitute one chunk's point update from the blocks at the
    current cameras ``cam`` and sum its trial error under ``trial_cam``,
    both under the current state's IRLS weights with ``huber_delta`` and
    through the distortion model with ``dist``. F delta_xi factors through
    the rank-2 blocks, so no (C, 3, 9F) coupling block is formed. Returns
    (X_new_c, e_trial_c, and the point side of the Nielsen gain ratio's
    predicted reduction: dDd_c, g_d_c)."""
    a1, a2, b1, b2, res_p, res_q, vis_c = _chunk_factors(cam, X_c, x_c, vis_c, f0,
                                                         huber_delta, robust_kind, dist, model)
    d_P, matE = _point_grad_and_block(a1, a2, res_p, res_q, vis_c)
    einv = inv3x3(_damp(matE, c))
    nf = cam.f.shape[0]
    dxi = (delta_xi * free).reshape(nf, 9)
    vis_d = vis_c.expand(res_p.shape)
    s1 = vis_d * torch.einsum("pfi,fi->pf", b1, dxi)
    s2 = vis_d * torch.einsum("pfi,fi->pf", b2, dxi)
    f_dxi = 2.0 * (torch.einsum("pf,pfx->px", s1, a1) + torch.einsum("pf,pfx->px", s2, a2))
    delta_x = -torch.einsum("pxy,py->px", einv, f_dxi + d_P)
    X_new = X_c + delta_x
    diag_e = torch.diagonal(matE, dim1=-2, dim2=-1)
    dDd_c = torch.sum(delta_x * diag_e * delta_x)
    gd_c = torch.sum(d_P * delta_x)
    e_c = _state_error(trial_cam._replace(X=X_new), x_c, vis_c, f0, dist, model)
    return X_new, e_c, dDd_c, gd_c


class _Derivs(NamedTuple):
    """Derivative blocks of one outer LM iteration."""

    d_P: torch.Tensor  # (..., P, 3) gradient wrt points
    d_F: torch.Tensor  # (..., 9F) gradient wrt cameras (gauge-masked)
    matE: torch.Tensor  # (..., P, 3, 3) point blocks
    matF: torch.Tensor  # (..., P, 3, 9F) coupling blocks (gauge-masked columns)
    matG: torch.Tensor  # (..., F, 9, 9) camera blocks


def _psum(v: torch.Tensor, axis_name: str | None) -> torch.Tensor:
    """Sum over the ranks of the mesh axis ``axis_name`` (identity with
    none), the counterpart of JAX's ``psum``: ``all_reduce`` on the
    process group that the running sharded call bound to the name
    (``parallel.mesh.bind_axes``); an unbound name raises ``ValueError``.
    ``v`` is reduced in place, so callers pass a fresh result."""
    if axis_name is None:
        return v
    from ..parallel.mesh import axis_group

    group = axis_group(axis_name)
    v = v.contiguous()
    torch.distributed.all_reduce(v, group=group)
    return v


def _compute_derivs(state: BAState, x, vis, free, f0: float, dist=None,
                    model: str | None = None, axis_name: str | None = None):
    """All first and second derivative blocks for one outer LM iteration,
    through the distortion model with ``dist``. Returns (derivs, current
    E). vis is (..., P, F), or a (P, 1) column that broadcasts; under a
    robust loss it carries the IRLS weights (:func:`_huber_weights`), and
    E is the weighted one. With ``axis_name`` the camera-side sums (E,
    d_F, matG) are all-reduced; the point-side blocks stay local."""
    d_P, d_F, matE, matF, matG, e_now = _chunk_blocks(state, state.X, x, vis, free, f0,
                                                      dist=dist, model=model)
    return _Derivs(d_P=d_P, d_F=_psum(d_F, axis_name), matE=matE, matF=matF.mul_(free),
                   matG=_psum(matG, axis_name)), _psum(e_now, axis_name)


def _damp(m: torch.Tensor, c) -> torch.Tensor:
    """Blocks (..., n, n) with their diagonals scaled by (1 + c); c is one
    damping or one per lane (the leading dimensions of m)."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    if torch.is_tensor(c):
        c = lane_view(c, m)
    return m + c * m * eye


def _chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems a x = b (..., n, n) by Cholesky. A factor that
    fails (the damped system is not positive definite) gives a NaN
    solution for that system, so the trial is rejected like any other, as
    ``cho_factor``'s NaNs are in the JAX package; the check stays on the
    card."""
    l, info = torch.linalg.cholesky_ex(a)
    sol = torch.cholesky_solve(b[..., None], l)[..., 0]
    return torch.where(info[..., None] == 0, sol, torch.full_like(sol, float("nan")))


def _reduced_camera_system(schur: torch.Tensor, matGc: torch.Tensor, free: torch.Tensor):
    """(..., 9F, 9F) damped reduced camera system blockdiag(Gc) - schur,
    with identity rows and columns at the gauge-fixed parameters."""
    nf = matGc.shape[-3]
    a = -schur
    blocks = a.view(a.shape[:-2] + (nf, 9, nf, 9))
    torch.diagonal(blocks, dim1=-4, dim2=-2).add_(matGc.movedim(-3, -1))
    return a * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)


def _camera_side_solve(derivs: _Derivs, matEc, matGc, free):
    """Camera-block elimination of the same damped system, for 3P < 9F: the
    camera blocks are 9x9 block-diagonal, so their inverse is closed form
    (``inv9_spd``) and the dense solve is (3P, 3P). Fixed parameters move
    exactly zero."""
    lead = derivs.matE.shape[:-3]
    npts = derivs.matE.shape[-3]
    nf9 = derivs.matF.shape[-1]
    nf = nf9 // 9
    free_b = free.view(nf, 9)
    matGm = matGc * (free_b[:, :, None] * free_b[:, None, :])
    matGm = matGm + torch.eye(9, dtype=matGc.dtype, device=matGc.device) * (1.0 - free_b)[:, :, None]
    ginv = inv9_spd(matGm)  # (..., F, 9, 9)

    fc = derivs.matF.view(lead + (npts, 3, nf, 9))
    h = torch.einsum("...pifa,...fab->...pifb", fc, ginv).reshape(lead + (npts * 3, nf9))
    # the (3P, 3P) Schur complement of the camera block, one product
    s = -(h @ derivs.matF.view(lead + (npts * 3, nf9)).transpose(-1, -2))
    torch.diagonal(s.view(lead + (npts, 3, npts, 3)), dim1=-4, dim2=-2).add_(
        matEc.movedim(-3, -1))

    d_F = derivs.d_F.view(lead + (nf, 9))
    gd = torch.einsum("...fab,...fb->...fa", ginv, d_F)
    rhs = -derivs.d_P + torch.einsum("...pifa,...fa->...pi", fc, gd)
    delta_x = _chol_solve(s, rhs.reshape(lead + (npts * 3,))).view(lead + (npts, 3))

    ftdx = torch.einsum("...pifa,...pi->...fa", fc, delta_x)
    delta_xi = -torch.einsum("...fab,...fb->...fa", ginv, d_F + ftdx).reshape(lead + (nf9,))
    return delta_xi * free, delta_x


def _damped_solve(derivs: _Derivs, c, free, axis_name: str | None = None):
    """Solve the damped normal equations by the point-block Schur
    complement, or from the camera side when 3P < 9F and the points are
    not sharded. Returns (delta_xi (..., 9F), delta_X (..., P, 3));
    gauge-fixed entries of delta_xi are exactly zero. With ``axis_name``
    the Schur product and its rhs are all-reduced, and every rank solves
    the same (9F, 9F) system."""
    lead = derivs.matE.shape[:-3]
    npts = derivs.matE.shape[-3]
    nf9 = derivs.matF.shape[-1]
    matEc = _damp(derivs.matE, c)
    matGc = _damp(derivs.matG, c)
    if axis_name is None and npts * 3 < nf9:
        return _camera_side_solve(derivs, matEc, matGc, free)

    einv = inv3x3(matEc)  # (..., P, 3, 3)
    einv_f = torch.einsum("...pxy,...pym->...pxm", einv, derivs.matF)  # (..., P, 3, 9F)
    # A = blockdiag(Gc) - sum_p F^T Einv F as one (9F, 3P) x (3P, 9F) product
    flat = lead + (npts * 3, nf9)
    schur = _psum(derivs.matF.view(flat).transpose(-1, -2) @ einv_f.view(flat), axis_name)
    a = _reduced_camera_system(schur, matGc, free)
    del schur
    b = _psum(torch.einsum("...pxm,...px->...m", einv_f, derivs.d_P), axis_name) - derivs.d_F
    del einv_f
    delta_xi = _chol_solve(a, b) * free

    rhs = torch.einsum("...pxm,...m->...px", derivs.matF, delta_xi) + derivs.d_P
    delta_x = -torch.einsum("...pxy,...py->...px", einv, rhs)
    return delta_xi, delta_x


def _predicted_reduction(derivs: _Derivs, delta_xi, delta_x, c,
                         axis_name: str | None = None) -> torch.Tensor:
    """Predicted decrease of the damped quadratic model,
    1/2 (c d^T D d - g^T d) with D = diag(H): the denominator of the
    Nielsen gain ratio, per lane; its point side all-reduced with
    ``axis_name``."""
    diag_e = torch.diagonal(derivs.matE, dim1=-2, dim2=-1)  # (..., P, 3)
    diag_g = torch.diagonal(derivs.matG, dim1=-2, dim2=-1)  # (..., F, 9)
    diag_g = diag_g.reshape(diag_g.shape[:-2] + (-1,))
    dDd = (_psum(torch.sum(delta_x * diag_e * delta_x, dim=(-2, -1)), axis_name)
           + torch.sum(delta_xi * diag_g * delta_xi, dim=-1))
    g_d = (_psum(torch.sum(derivs.d_P * delta_x, dim=(-2, -1)), axis_name)
           + torch.sum(derivs.d_F * delta_xi, dim=-1))
    return 0.5 * (c * dDd - g_d)


def _apply_update(state: BAState, delta_xi: torch.Tensor, delta_x: torch.Tensor) -> BAState:
    """Parameter update; rotations through the axis-angle exponential."""
    d = delta_xi.reshape(state.f.shape + (9,))
    return BAState(
        X=state.X + delta_x,
        f=state.f + d[..., 0],
        u=state.u + d[..., 1:3],
        t=state.t + d[..., 3:6],
        R=rodrigues(d[..., 6:9]) @ state.R,
    )


def _residuals(state: BAState, x, vis, f0: float, dist=None, model: str | None = None):
    """Per-observation (res_p, res_q), through the distortion model with
    ``dist``, masked entries sanitized."""
    K = build_K(state.f, state.u, f0)
    _, p, q, r = calc_pqr(state.X, K, state.R, state.t)
    r = torch.where(vis > 0, r, torch.ones_like(r))
    return _distorted_residual(state, p, q, r, x, f0, dist, model)


def _state_error(state: BAState, x, vis, f0: float, dist=None,
                 model: str | None = None, axis_name: str | None = None) -> torch.Tensor:
    """Reprojection error E of ``state`` over the observations x
    (..., P, F, 2), per lane; through the distortion model with ``dist``;
    all-reduced with ``axis_name``."""
    if dist is None:
        _, p, q, r = calc_pqr(state.X, build_K(state.f, state.u, f0), state.R, state.t)
        return _psum(reprojection_error(x, p, q, r, vis, f0), axis_name)
    res_p, res_q = _residuals(state, x, vis, f0, dist, model)
    return _psum(torch.sum(vis * (res_p**2 + res_q**2), dim=(-2, -1)), axis_name)


ROBUST_LOSSES = ("huber", "cauchy", "soft_l1", "arctan")


def resolve_robust(robust: str | None) -> str | None:
    """Normalize ``LMConfig.robust``: None, "" and "none" mean plain least
    squares (None); any other value must name a loss of ``ROBUST_LOSSES``,
    else ``ValueError``."""
    if robust in (None, "", "none"):
        return None
    if robust not in ROBUST_LOSSES:
        raise ValueError(f"unknown robust loss: {robust!r} (use {ROBUST_LOSSES} or None)")
    return robust


def robust_weight(mag: torch.Tensor, delta: float, kind: str = "huber") -> torch.Tensor:
    """IRLS weight w = rho'(s) at s = mag^2 for the robust losses (the ceres
    LossFunction family; delta is the scale in residual-magnitude units):

    - huber:   min(1, delta / |r|), a quadratic core with a linear tail;
    - cauchy:  1 / (1 + s / delta^2);
    - soft_l1: 1 / sqrt(1 + s / delta^2), the smooth pseudo-Huber;
    - arctan:  1 / (1 + (s / delta^2)^2), hard redescending.
    """
    if kind == "huber":
        return torch.clamp_max(delta / torch.clamp_min(mag, 1e-12), 1.0)
    s_rel = (mag / delta) ** 2
    if kind == "cauchy":
        return 1.0 / (1.0 + s_rel)
    if kind == "soft_l1":
        return 1.0 / torch.sqrt(1.0 + s_rel)
    if kind == "arctan":
        return 1.0 / (1.0 + s_rel * s_rel)
    raise ValueError(f"unknown robust loss: {kind!r} (use {ROBUST_LOSSES})")


DISTORTION_MODELS = ("radial", "opencv", "fisheye", "full_opencv", "fov", "thin_prism")
_DISTORTION_NCOLS = {"radial": 2, "opencv": 4, "fisheye": 4, "full_opencv": 8, "fov": 1,
                     "thin_prism": 8}


def resolve_distortion_model(dist, model: str | None = "auto") -> str:
    """Concrete distortion-model name from (columns, requested model).
    "auto" (``LMConfig.distortion_model``'s default) keeps the column-count
    convention: (F, 2) BAL radial, (F, 4) OPENCV, (F, 1) FOV, (F, 8) full
    OPENCV. OPENCV_FISHEYE also has 4 parameters and THIN_PRISM_FISHEYE 8,
    so they must be asked for by name. An unknown name or a column count
    that does not fit raises ``ValueError``."""
    if model in (None, "auto"):
        if dist is None:
            return "radial"
        n = int(dist.shape[-1])
        names = {1: "fov", 2: "radial", 4: "opencv", 8: "full_opencv"}
        if n not in names:
            raise ValueError(f"distortion must have 1, 2, 4, or 8 columns, got {n}")
        return names[n]
    if model not in DISTORTION_MODELS:
        raise ValueError(f"unknown distortion model: {model!r}")
    if dist is not None and int(dist.shape[-1]) != _DISTORTION_NCOLS[model]:
        raise ValueError(f"{model} distortion expects {_DISTORTION_NCOLS[model]} columns, "
                         f"got {dist.shape[-1]}")
    return model


def default_distortion(model: str, nf: int, dtype, device=None) -> torch.Tensor:
    """Refit-from-scratch initial distortion: zero for the polynomial
    families; the FOV angle starts at 0.5 rad, because at 0 (the pinhole
    limit) dd/domega vanishes and its Gauss-Newton refit would stay
    there."""
    if model == "fov":
        return torch.full((nf, 1), 0.5, dtype=dtype, device=device)
    return torch.zeros((nf, _DISTORTION_NCOLS[model]), dtype=dtype, device=device)


def distortion_nterms(model: str) -> int:
    """Columns of the per-camera accumulands of one refit pass
    (:func:`_refit_terms`): the normal matrix and right-hand side of the
    linear solve, the (5, 5) layout of either full-OPENCV round, or the
    FOV step's numerator and denominator."""
    return {"radial": 5, "full_opencv": 30, "fov": 2, "thin_prism": 72}.get(model, 20)


def _per_camera(v: torch.Tensor) -> torch.Tensor:
    """(..., F) per-camera values -> (..., 1, F), broadcasting over points."""
    return v[..., None, :]


def _distortion_terms(state: BAState, p, q, r, f0: float, dist, model: str | None = None):
    """Per-observation radial quantities (g1, g2, s, d, wu): the distorted
    prediction is ``d g + u/f0`` with g = (p/r, q/r) - u/f0, and the exact
    2x2 Jacobian chain is ``D = d I + wu (f0/f)^2 g g^T``, with s =
    (f0/f)^2 |g|^2 the squared radius of the normalized ray rho.

    BAL radial (``runtime/io.py::load_bal``): pixel = f d(s) rho,
    d = 1 + k1 s + k2 s^2, wu = 2 dd/ds; OPENCV shares it (its tangential
    shift is :func:`_tangential_terms`). Fisheye, full OPENCV (the
    rational N/D, plus the tangential shift) and FOV have their own
    (d, wu) (:func:`_fisheye_scale`, :func:`_rational_scale`,
    :func:`_fov_scale`). Thin prism has no scalar (d, wu) form and raises
    ``ValueError`` (:func:`_thin_prism_terms`). ``r`` must already be
    sanitized (nonzero where masked)."""
    model = resolve_distortion_model(dist, model)
    g1 = p / r - _per_camera(state.u[..., 0] / f0)
    g2 = q / r - _per_camera(state.u[..., 1] / f0)
    s = _per_camera((f0 / state.f) ** 2) * (g1 * g1 + g2 * g2)
    if model == "fisheye":
        d, wu = _fisheye_scale(s, dist)
    elif model == "full_opencv":
        d, wu = _rational_scale(s, dist)
    elif model == "fov":
        d, wu = _fov_scale(s, dist)
    elif model == "thin_prism":
        raise ValueError("thin_prism is a two-stage model (equidistant base + theta-plane "
                         "shift) and has no scalar (d, wu) form: use _thin_prism_terms and "
                         "_apply_thin_prism_chain")
    else:
        k1 = _per_camera(dist[..., 0])
        k2 = _per_camera(dist[..., 1])
        d = 1.0 + s * (k1 + s * k2)
        wu = 2.0 * (k1 + 2.0 * k2 * s)
    return g1, g2, s, d, wu


def _fov_scale(s: torch.Tensor, dist: torch.Tensor):
    """(d, d'/rn) of the FOV model (Devernay-Faugeras, COLMAP model 7) at
    rn = sqrt(s): r_d = atan(2 rn tan(w/2)) / w and d = r_d / rn, with
    ``dist`` (F, 1) the field-of-view angle w.

    Both are even in rn: d -> 2 T / w and d'/rn -> -16 T^3 / (3 w) as
    rn -> 0 (T = tan(w/2)). Below s = 1e-12 the Taylor branch is taken,
    and the exact branch sees s = 1 there, so a gradient through the
    unused branch stays finite. |w| < 1e-6 is the pinhole limit (d = 1,
    no curvature): w divides everything, so it is guarded the same way."""
    w = _per_camera(dist[..., 0])
    pinhole = torch.abs(w) < 1e-6
    w_safe = torch.where(pinhole, torch.ones_like(w), w)
    t = torch.tan(0.5 * w_safe)
    small = s < 1e-12
    s_safe = torch.where(small, torch.ones_like(s), s)
    rn = torch.sqrt(s_safe)
    a = torch.atan2(2.0 * rn * t, torch.ones_like(rn))
    d_exact = a / (w_safe * rn)
    ap = 2.0 * t / (1.0 + 4.0 * t * t * s_safe)  # dA/drn
    wu_exact = (ap * rn - a) / (w_safe * s_safe * rn)
    d_taylor = (2.0 * t / w_safe) * (1.0 - (4.0 / 3.0) * t * t * s)
    wu_taylor = -(16.0 / 3.0) * t**3 / w_safe
    d = torch.where(small, d_taylor, d_exact)
    wu = torch.where(small, wu_taylor, wu_exact)
    return torch.where(pinhole, 1.0, d), torch.where(pinhole, 0.0, wu)


def _fov_domega(s: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """dd/dw of the FOV scale at fixed geometry, the regressor of its
    Gauss-Newton refit: (1 + T^2) / (w (1 + 4 T^2 s)) - A / (w^2 rn),
    finite at rn -> 0 (A/rn -> 2T) and zero at the pinhole limit."""
    w = _per_camera(dist[..., 0])
    pinhole = torch.abs(w) < 1e-6
    w_safe = torch.where(pinhole, torch.ones_like(w), w)
    t = torch.tan(0.5 * w_safe)
    small = s < 1e-12
    s_safe = torch.where(small, torch.ones_like(s), s)
    rn = torch.sqrt(s_safe)
    a_over_rn = torch.where(small, 2.0 * t, torch.atan2(2.0 * rn * t, torch.ones_like(rn)) / rn)
    dd = (1.0 + t * t) / (w_safe * (1.0 + 4.0 * t * t * s_safe)) - a_over_rn / (w_safe * w_safe)
    return torch.where(pinhole, 0.0, dd)


def _rational_scale(s: torch.Tensor, dist: torch.Tensor):
    """(d, 2 dd/ds) of the OpenCV rational model: d = N/D with
    N = 1 + k1 s + k2 s^2 + k3 s^3 and D = 1 + k4 s + k5 s^2 + k6 s^3
    (``dist`` (F, 8) = (k1..k6, p1, p2)); exact everywhere (D = 1 at the
    principal point)."""
    k = [_per_camera(dist[..., i]) for i in range(6)]
    num = 1.0 + s * (k[0] + s * (k[1] + s * k[2]))
    den = 1.0 + s * (k[3] + s * (k[4] + s * k[5]))
    dnum = k[0] + s * (2.0 * k[1] + s * (3.0 * k[2]))
    dden = k[3] + s * (2.0 * k[4] + s * (3.0 * k[5]))
    return num / den, 2.0 * (dnum * den - num * dden) / (den * den)


def _fisheye_scale(s: torch.Tensor, dist: torch.Tensor):
    """(m, m'/rn) of the equidistant theta-polynomial (OPENCV_FISHEYE) at
    rn = sqrt(s): with theta = atan(rn) and theta_d = theta (1 + k1 theta^2
    + k2 theta^4 + k3 theta^6 + k4 theta^8), m = theta_d / rn and
    m'/rn = (theta_d'(theta) / (1 + rn^2) - m) / rn^2. Both tend to
    1 + (k1 - 1/3) s and 2 (k1 - 1/3) at the principal point, the Taylor
    branch below s = 1e-12; the exact branch sees s = 1 there, so a
    gradient through it stays finite."""
    k1, k2, k3, k4 = (_per_camera(dist[..., i]) for i in range(4))
    small = s < 1e-12
    s_safe = torch.where(small, torch.ones_like(s), s)
    rn = torch.sqrt(s_safe)
    th = torch.atan(rn)
    th2 = th * th
    poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
    dpoly = k1 + th2 * (2.0 * k2 + th2 * (3.0 * k3 + th2 * (4.0 * k4)))
    m_exact = th * poly / rn
    wu_exact = ((poly + 2.0 * th2 * dpoly) / (1.0 + s_safe) - m_exact) / s_safe
    c0 = k1 - (1.0 / 3.0)
    return torch.where(small, 1.0 + c0 * s, m_exact), torch.where(small, 2.0 * c0, wu_exact)


def _thin_prism_terms(state: BAState, g1, g2, f0: float, dist):
    """Per-observation quantities of COLMAP's THIN_PRISM_FISHEYE (model
    10): the equidistant base psi = (theta / |x_n|) x_n, then an
    OPENCV-style polynomial and thin-prism shift in the theta plane:

        rho2   = |psi|^2 = theta^2
        radial = k1 rho2 + k2 rho2^2 + k3 rho2^3 + k4 rho2^4
        du1    = psi1 radial + 2 p1 psi1 psi2 + p2 (rho2 + 2 psi1^2) + sx1 rho2
        du2    = psi2 radial + p1 (rho2 + 2 psi2^2) + 2 p2 psi1 psi2 + sy1 rho2

    ``dist`` (F, 8) = (k1, k2, k3, k4, p1, p2, sx1, sy1). Returns (m0, wu0,
    psi1, psi2, du1, du2, J11, J12, J21, J22, s): (m0, wu0) the k = 0
    fisheye scale and weight at s = |x_n|^2, J the shift's Jacobian wrt
    psi, which sx1 and sy1 make asymmetric."""
    c = _per_camera(f0 / state.f)
    s = c * c * (g1 * g1 + g2 * g2)
    m0, wu0 = _fisheye_scale(s, dist.new_zeros(dist.shape[:-1] + (4,)))
    psi1 = m0 * c * g1
    psi2 = m0 * c * g2
    rho2 = psi1 * psi1 + psi2 * psi2  # theta^2
    k1, k2, k3, k4, p1, p2, sx1, sy1 = (_per_camera(dist[..., i]) for i in range(8))
    radial = rho2 * (k1 + rho2 * (k2 + rho2 * (k3 + rho2 * k4)))
    dradial = k1 + rho2 * (2.0 * k2 + rho2 * (3.0 * k3 + rho2 * (4.0 * k4)))
    du1 = (psi1 * radial + 2.0 * p1 * psi1 * psi2 + p2 * (rho2 + 2.0 * psi1 * psi1)
           + sx1 * rho2)
    du2 = (psi2 * radial + p1 * (rho2 + 2.0 * psi2 * psi2) + 2.0 * p2 * psi1 * psi2
           + sy1 * rho2)
    two_dr = 2.0 * dradial
    j11 = radial + psi1 * two_dr * psi1 + 2.0 * p1 * psi2 + 6.0 * p2 * psi1 + 2.0 * sx1 * psi1
    j12 = psi1 * two_dr * psi2 + 2.0 * p1 * psi1 + 2.0 * p2 * psi2 + 2.0 * sx1 * psi2
    j21 = psi2 * two_dr * psi1 + 2.0 * p1 * psi1 + 2.0 * p2 * psi2 + 2.0 * sy1 * psi1
    j22 = radial + psi2 * two_dr * psi2 + 6.0 * p1 * psi2 + 2.0 * p2 * psi1 + 2.0 * sy1 * psi2
    return m0, wu0, psi1, psi2, du1, du2, j11, j12, j21, j22, s


def _tangential_terms(state: BAState, g1, g2, f0: float, dist):
    """The tangential shift (t1, t2) = c h(g), c = f0/f, of (p1, p2) and its
    symmetric Jacobian wrt g (T11, T12, T22), which adds onto the radial
    2x2 chain; c's 1/f is the one extra camera dependence (the -t/f term
    of the f column). (p1, p2) are columns 2 and 3 of OPENCV's (k1, k2,
    p1, p2) and columns 6 and 7 of full OPENCV's (k1..k6, p1, p2)."""
    c = _per_camera(f0 / state.f)
    pcol = 6 if dist.shape[-1] == 8 else 2
    p1 = _per_camera(dist[..., pcol])
    p2 = _per_camera(dist[..., pcol + 1])
    g11, g22, g12 = g1 * g1, g2 * g2, g1 * g2
    t1 = c * (2.0 * p1 * g12 + p2 * (3.0 * g11 + g22))
    t2 = c * (p1 * (g11 + 3.0 * g22) + 2.0 * p2 * g12)
    t11 = 2.0 * c * (p1 * g2 + 3.0 * p2 * g1)
    t12 = 2.0 * c * (p1 * g1 + p2 * g2)
    t22 = 2.0 * c * (3.0 * p1 * g2 + p2 * g1)
    return t1, t2, t11, t12, t22


def _chain_rows(d11, d12, d21, d22, a1, a2, b1, b2, f0: float):
    """The factor rows through the 2x2 Jacobian D = [[d11, d12], [d21,
    d22]] of the distorted prediction wrt g: the point rows a verbatim, the
    camera rows b as dg/dtheta (the u columns less 1/f0) with the
    prediction's own +1/f0 added back. b1 and b2 are overwritten."""
    d11, d12, d21, d22 = (d[..., None] for d in (d11, d12, d21, d22))
    a1, a2 = d11 * a1 + d12 * a2, d21 * a1 + d22 * a2
    inv_f0 = 1.0 / f0
    b1[..., 1] -= inv_f0
    b2[..., 2] -= inv_f0
    b1, b2 = d11 * b1 + d12 * b2, d21 * b1 + d22 * b2
    b1[..., 1] += inv_f0
    b2[..., 2] += inv_f0
    return a1, a2, b1, b2


def _apply_distortion_chain(state: BAState, p, q, r, f0: float, dist, res_p, res_q, a1, a2,
                            b1, b2, model: str | None = None):
    """The residuals and the rank-2 Jacobian factors through the distortion
    model (the dense and the chunked derivative builds share it).

    The distorted prediction is d g + u/f0, plus the tangential shift t(g)
    under OPENCV and full OPENCV. The residual gains (d - 1) g (+ t); the
    point rows (a, (..., C, F, 3)) chain through the 2x2 Jacobian D = d I +
    wu (f0/f)^2 g g^T (+ dt/dg, also symmetric) verbatim; the camera rows
    (b, (..., C, F, 9)) differ from dg/dtheta in the u columns
    (:func:`_chain_rows`) and the f column (s and c depend on f directly:
    -(wu s / f) g - t/f). Thin prism has its own, asymmetric chain
    (:func:`_apply_thin_prism_chain`). b1 and b2 are overwritten."""
    model = resolve_distortion_model(dist, model)
    if model == "thin_prism":
        return _apply_thin_prism_chain(state, p, q, r, f0, dist, res_p, res_q, a1, a2, b1, b2)
    g1, g2, s, d, wu = _distortion_terms(state, p, q, r, f0, dist, model)
    tangential = model in ("opencv", "full_opencv")
    res_p = res_p + (d - 1.0) * g1
    res_q = res_q + (d - 1.0) * g2
    cw = wu * _per_camera(f0 / state.f) ** 2
    d11 = d + cw * g1 * g1
    d12 = cw * g1 * g2
    d22 = d + cw * g2 * g2
    if tangential:
        t1, t2, t11, t12, t22 = _tangential_terms(state, g1, g2, f0, dist)
        res_p = res_p + t1
        res_q = res_q + t2
        d11 = d11 + t11
        d12 = d12 + t12
        d22 = d22 + t22
    a1, a2, b1, b2 = _chain_rows(d11, d12, d12, d22, a1, a2, b1, b2, f0)
    cf = wu * s / _per_camera(state.f)  # -(wu s / f) g on the f column
    b1[..., 0] -= cf * g1
    b2[..., 0] -= cf * g2
    if tangential:
        inv_f = 1.0 / _per_camera(state.f)  # -t/f: c = f0/f explicit in t
        b1[..., 0] -= t1 * inv_f
        b2[..., 0] -= t2 * inv_f
    return res_p, res_q, a1, a2, b1, b2


def _apply_thin_prism_chain(state: BAState, p, q, r, f0: float, dist, res_p, res_q, a1, a2,
                            b1, b2):
    """The THIN_PRISM_FISHEYE chain: the prediction composes the
    equidistant base with the theta-plane shift (:func:`_thin_prism_terms`),
    so D = (I + J) M with M = m0 I + wu0 (f0/f)^2 g g^T is asymmetric, and
    the f column gains G~/f - (I + J) g / (f (1 + s)) (G~ the distorted g
    part), which is the fisheye one at zero shift. b1 and b2 are
    overwritten."""
    g1 = p / r - _per_camera(state.u[..., 0] / f0)
    g2 = q / r - _per_camera(state.u[..., 1] / f0)
    m0, wu0, _, _, du1, du2, j11, j12, j21, j22, s = _thin_prism_terms(state, g1, g2, f0, dist)
    inv_c = _per_camera(state.f / f0)  # theta plane -> image coordinates
    dug1 = du1 * inv_c
    dug2 = du2 * inv_c
    res_p = res_p + (m0 - 1.0) * g1 + dug1
    res_q = res_q + (m0 - 1.0) * g2 + dug2
    cw = wu0 * _per_camera(f0 / state.f) ** 2
    m11 = m0 + cw * g1 * g1
    m12 = cw * g1 * g2
    m22 = m0 + cw * g2 * g2
    d11 = (1.0 + j11) * m11 + j12 * m12
    d12 = (1.0 + j11) * m12 + j12 * m22
    d21 = j21 * m11 + (1.0 + j22) * m12
    d22 = j21 * m12 + (1.0 + j22) * m22
    a1, a2, b1, b2 = _chain_rows(d11, d12, d21, d22, a1, a2, b1, b2, f0)
    inv_f = 1.0 / _per_camera(state.f)
    damp = inv_f / (1.0 + s)
    b1[..., 0] += (m0 * g1 + dug1) * inv_f - ((1.0 + j11) * g1 + j12 * g2) * damp
    b2[..., 0] += (m0 * g2 + dug2) * inv_f - (j21 * g1 + (1.0 + j22) * g2) * damp
    return res_p, res_q, a1, a2, b1, b2


def _distorted_residual(state: BAState, p, q, r, x, f0: float, dist=None,
                        model: str | None = None):
    """(res_p, res_q) through the distortion model from sanitized
    (p, q, r): the trial-error expression shared by the cores."""
    res_p = p / r - x[..., 0] / f0
    res_q = q / r - x[..., 1] / f0
    if dist is None:
        return res_p, res_q
    model = resolve_distortion_model(dist, model)
    if model == "thin_prism":
        g1 = p / r - _per_camera(state.u[..., 0] / f0)
        g2 = q / r - _per_camera(state.u[..., 1] / f0)
        m0, _, _, _, du1, du2, *_ = _thin_prism_terms(state, g1, g2, f0, dist)
        inv_c = _per_camera(state.f / f0)
        return res_p + (m0 - 1.0) * g1 + du1 * inv_c, res_q + (m0 - 1.0) * g2 + du2 * inv_c
    g1, g2, _, d, _ = _distortion_terms(state, p, q, r, f0, dist, model)
    res_p = res_p + (d - 1.0) * g1
    res_q = res_q + (d - 1.0) * g2
    if model in ("opencv", "full_opencv"):
        t1, t2, _, _, _ = _tangential_terms(state, g1, g2, f0, dist)
        res_p = res_p + t1
        res_q = res_q + t2
    return res_p, res_q


def _huber_weights(state: BAState, x, vis, f0: float, delta: float,
                   robust_kind: str = "huber", dist=None, model: str | None = None):
    """vis times the IRLS weights of ``robust_kind`` at the current
    (distorted, with ``dist``) residuals, (..., P, F): multiplied into the
    visibility, gross outliers stop dominating the normal equations."""
    res_p, res_q = _residuals(state, x, vis, f0, dist, model)
    return vis * robust_weight(torch.sqrt(res_p**2 + res_q**2), delta, robust_kind)


# The rational model's prediction is not jointly linear in (k1..k6, p1,
# p2), but the algebraic residual D (T - t) - N g = 0, cross-multiplied by
# the denominator, is linear in (k1, k2, k3, p1, p2) given D and in (k4,
# k5, k6) given the rest; the refit alternates the two exact linear solves.
FULL_OPENCV_ALTERNATIONS = 4
_FOV_GN_STEPS = 6


def fit_distortion(state: BAState, x, vis, f0: float, shared: bool = False,
                   axis_name=None, tangential: bool = False, model: str | None = None,
                   dist=None) -> torch.Tensor:
    """Distortion refit at the current geometry.

    The BAL radial prediction (1 + k1 s + k2 s^2) g + u/f0 is linear in
    (k1, k2), so the least-squares distortion for the state is a 2x2
    normal-equation solve per camera. OPENCV (``tangential=True`` or
    ``model="opencv"``) and fisheye are linear in their four parameters
    (4x4), thin prism in its eight (8x8). Full OPENCV alternates
    ``FULL_OPENCV_ALTERNATIONS`` times a numerator and a denominator solve,
    and FOV takes ``_FOV_GN_STEPS`` scalar Gauss-Newton steps on its angle;
    both start from ``dist`` (``default_distortion`` when None). Every
    pass is a sum over points (:func:`_refit_rounds`). ``shared=True``
    ties the parameters across the cameras: the per-camera terms sum into
    one system. A camera whose system is degenerate gets zeros (a FOV or
    full-OPENCV camera keeps its current values). With ``axis_name`` each
    pass's terms are all-reduced before its solve."""
    if model is None:
        model = "opencv" if tangential else "radial"
    _, p, q, r = calc_pqr(state.X, build_K(state.f, state.u, f0), state.R, state.t)
    cur = default_distortion(model, state.f.shape[-1], x.dtype, x.device) if dist is None else dist
    for round_ in _refit_rounds(model):
        terms = _psum(_refit_terms(state, p, q, r, x, vis, f0, model, cur, round_), axis_name)
        cur = _refit_solve(terms, cur, model, round_, shared)
    return cur


def _refit_rounds(model: str) -> tuple:
    """The passes of one refit, each a sum over points and a solve: one
    for the models linear in their parameters, the (numerator,
    denominator) alternation for full OPENCV, the Gauss-Newton steps for
    FOV."""
    if model == "full_opencv":
        return ("num", "den") * FULL_OPENCV_ALTERNATIONS
    if model == "fov":
        return (None,) * _FOV_GN_STEPS
    return (None,)


def _refit_terms(state: BAState, p, q, r, x, vis, f0: float, model: str, cur, round_):
    """The (F, ``distortion_nterms(model)``) accumulands of one refit pass
    at the current distortion ``cur``."""
    if model == "full_opencv":
        return _full_opencv_lsq_terms(state, p, q, r, x, vis, f0, cur, round_)
    if model == "fov":
        return _fov_gn_terms(state, p, q, r, x, vis, f0, cur)
    return _distortion_lsq_terms(state, p, q, r, x, vis, f0, model)


def _refit_solve(terms: torch.Tensor, cur, model: str, round_, shared: bool) -> torch.Tensor:
    """The distortion after one refit pass from its summed terms."""
    if model == "full_opencv":
        return _solve_full_opencv_round(terms, cur, round_, shared)
    if model == "fov":
        return _solve_fov_step(terms, cur, shared)
    return _solve_distortion_lsq(terms, shared)


def _normal_terms(A: torch.Tensor, T: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """(F, n^2 + n) vis-weighted normal equations of the regressors A
    (P, F, n, 2) against the targets T (P, F, 2): the n x n matrix by rows,
    then the right-hand side."""
    m = torch.einsum("...pfai,...pfbi,...pf->...fab", A, A, vis)
    rhs = torch.einsum("...pfai,...pfi,...pf->...fa", A, T, vis)
    return torch.cat([m.reshape(m.shape[:-2] + (-1,)), rhs], dim=-1)


def _distortion_lsq_terms(state: BAState, p, q, r, x, vis, f0: float, model="radial"):
    """Per-camera normal-equation accumulands of the linear-in-k fit, a sum
    over points (so the chunked and streamed cores add them up chunk by
    chunk): (F, 5) = (a11, a12, a22, b1, b2) for radial, (F, 20) = (the
    4x4 normal matrix by rows, the 4 rhs) for OPENCV and fisheye, (F, 72)
    for thin prism. vis is (P, F) or a (P, 1) column. ``model`` also takes
    the bool ``tangential``."""
    if isinstance(model, bool):
        model = "opencv" if model else "radial"
    elif model is None:
        model = "radial"
    vis = vis.expand(p.shape)
    r = torch.where(vis > 0, r, torch.ones_like(r))
    u1, u2 = _per_camera(state.u[..., 0] / f0), _per_camera(state.u[..., 1] / f0)
    g1 = p / r - u1
    g2 = q / r - u2
    s = _per_camera((f0 / state.f) ** 2) * (g1 * g1 + g2 * g2)
    # the target: what the distortion shift must explain, (x - u)/f0 - g
    t1 = x[..., 0] / f0 - u1 - g1
    t2 = x[..., 1] / f0 - u2 - g2
    if model == "radial":
        gg = g1 * g1 + g2 * g2
        gt = g1 * t1 + g2 * t2
        s2 = s * s
        return torch.stack([
            torch.sum(vis * s2 * gg, dim=-2),
            torch.sum(vis * s2 * s * gg, dim=-2),
            torch.sum(vis * s2 * s2 * gg, dim=-2),
            torch.sum(vis * s * gt, dim=-2),
            torch.sum(vis * s2 * gt, dim=-2),
        ], dim=-1)
    if model == "thin_prism":
        # the theta-plane shift is linear in all 8 parameters; in image
        # coordinates the regressors are the x_n-plane ones over c
        m0, _, psi1, psi2, *_ = _thin_prism_terms(state, g1, g2, f0,
                                                  g1.new_zeros(state.f.shape + (8,)))
        rho2 = psi1 * psi1 + psi2 * psi2
        # the target less the k = 0 equidistant base: (x - u)/f0 - m0 g
        t1 = t1 + (1.0 - m0) * g1
        t2 = t2 + (1.0 - m0) * g2
        zero = torch.zeros_like(rho2)
        A = torch.stack([
            torch.stack([rho2 * psi1, rho2 * psi2], dim=-1),
            torch.stack([rho2**2 * psi1, rho2**2 * psi2], dim=-1),
            torch.stack([rho2**3 * psi1, rho2**3 * psi2], dim=-1),
            torch.stack([rho2**4 * psi1, rho2**4 * psi2], dim=-1),
            torch.stack([2.0 * psi1 * psi2, rho2 + 2.0 * psi2**2], dim=-1),
            torch.stack([rho2 + 2.0 * psi1**2, 2.0 * psi1 * psi2], dim=-1),
            torch.stack([rho2, zero], dim=-1),
            torch.stack([zero, rho2], dim=-1),
        ], dim=-2) * _per_camera(state.f / f0)[..., None, None]  # (P, F, 8, 2)
        return _normal_terms(A, torch.stack([t1, t2], dim=-1), vis)
    if model == "fisheye":
        # regressors m0 theta^(2i) g against the target (x - u)/f0 - m0 g
        small = s < 1e-12
        s_safe = torch.where(small, torch.ones_like(s), s)
        rn = torch.sqrt(s_safe)
        th = torch.atan(rn)
        m0 = torch.where(small, 1.0 - s / 3.0, th / rn)
        t1 = t1 + (1.0 - m0) * g1
        t2 = t2 + (1.0 - m0) * g2
        th2 = torch.where(small, s, th * th)
        base1, base2 = m0 * g1, m0 * g2
        A = torch.stack([torch.stack([th2**i * base1, th2**i * base2], dim=-1)
                         for i in range(1, 5)], dim=-2)  # (P, F, 4, 2)
        return _normal_terms(A, torch.stack([t1, t2], dim=-1), vis)
    # OPENCV regressors, a 2-vector each per observation: the shift is
    # k1 A1 + k2 A2 + p1 A3 + p2 A4 (A3, A4 as in _tangential_terms)
    c = _per_camera(f0 / state.f)
    g11, g22, g12 = g1 * g1, g2 * g2, g1 * g2
    A = torch.stack([
        torch.stack([s * g1, s * g2], dim=-1),
        torch.stack([s * s * g1, s * s * g2], dim=-1),
        torch.stack([2.0 * c * g12, c * (g11 + 3.0 * g22)], dim=-1),
        torch.stack([c * (3.0 * g11 + g22), 2.0 * c * g12], dim=-1),
    ], dim=-2)  # (..., P, F, 4, 2)
    return _normal_terms(A, torch.stack([t1, t2], dim=-1), vis)


def _full_opencv_lsq_terms(state: BAState, p, q, r, x, vis, f0: float, dist, round_: str):
    """(F, 30) accumulands of one round of the full-OPENCV alternation, a
    sum over points: "num" solves (k1, k2, k3, p1, p2) with the denominator
    D frozen, "den" solves (k4, k5, k6) with N and (p1, p2) frozen (its
    regressors padded to the 5-column layout, so both rounds have one
    shape)."""
    vis = vis.expand(p.shape)
    r = torch.where(vis > 0, r, torch.ones_like(r))
    u1, u2 = _per_camera(state.u[..., 0] / f0), _per_camera(state.u[..., 1] / f0)
    g1 = p / r - u1
    g2 = q / r - u2
    s = _per_camera((f0 / state.f) ** 2) * (g1 * g1 + g2 * g2)
    t1 = x[..., 0] / f0 - u1  # the target T
    t2 = x[..., 1] / f0 - u2
    k = [_per_camera(dist[..., i]) for i in range(6)]
    den = 1.0 + s * (k[3] + s * (k[4] + s * k[5]))
    c = _per_camera(f0 / state.f)
    g11, g22, g12 = g1 * g1, g2 * g2, g1 * g2
    h11, h12 = 2.0 * c * g12, c * (3.0 * g11 + g22)  # dt/dp1, dt/dp2
    h21, h22 = c * (g11 + 3.0 * g22), 2.0 * c * g12
    if round_ == "num":
        # D T - D t - N g = 0, t = p1 h_1 + p2 h_2:
        # [s g, s^2 g, s^3 g, D h_1, D h_2] a = D T - g
        A = torch.stack([
            torch.stack([s * g1, s * g2], dim=-1),
            torch.stack([s * s * g1, s * s * g2], dim=-1),
            torch.stack([s**3 * g1, s**3 * g2], dim=-1),
            torch.stack([den * h11, den * h21], dim=-1),
            torch.stack([den * h12, den * h22], dim=-1),
        ], dim=-2)
        b1 = den * t1 - g1
        b2 = den * t2 - g2
    else:
        # N g + D (ts - T) = 0 with ts the tangential shift:
        # [s (ts - T), s^2 (ts - T), s^3 (ts - T)] b = (T - ts) - N g
        p1c, p2c = _per_camera(dist[..., 6]), _per_camera(dist[..., 7])
        ts1 = p1c * h11 + p2c * h12
        ts2 = p1c * h21 + p2c * h22
        num = 1.0 + s * (k[0] + s * (k[1] + s * k[2]))
        d1 = ts1 - t1
        d2 = ts2 - t2
        zeros = torch.zeros_like(s)
        A = torch.stack([
            torch.stack([s * d1, s * d2], dim=-1),
            torch.stack([s * s * d1, s * s * d2], dim=-1),
            torch.stack([s**3 * d1, s**3 * d2], dim=-1),
            torch.stack([zeros, zeros], dim=-1),
            torch.stack([zeros, zeros], dim=-1),
        ], dim=-2)
        b1 = (t1 - ts1) - num * g1
        b2 = (t2 - ts2) - num * g2
    return _normal_terms(A, torch.stack([b1, b2], dim=-1), vis)


def _fov_gn_terms(state: BAState, p, q, r, x, vis, f0: float, dist):
    """(F, 2) = (gradient numerator, Gauss-Newton denominator) accumulands
    of one scalar step on the FOV angle, a sum over points."""
    r = torch.where(vis > 0, r, torch.ones_like(r))
    u1, u2 = _per_camera(state.u[..., 0] / f0), _per_camera(state.u[..., 1] / f0)
    g1 = p / r - u1
    g2 = q / r - u2
    s = _per_camera((f0 / state.f) ** 2) * (g1 * g1 + g2 * g2)
    d, _ = _fov_scale(s, dist)
    dd = _fov_domega(s, dist)
    res1 = x[..., 0] / f0 - u1 - d * g1
    res2 = x[..., 1] / f0 - u2 - d * g2
    num = torch.sum(vis * dd * (res1 * g1 + res2 * g2), dim=-2)
    den = torch.sum(vis * dd * dd * (g1 * g1 + g2 * g2), dim=-2)
    return torch.stack([num, den], dim=-1)


def _solve_fov_step(terms: torch.Tensor, dist: torch.Tensor, shared: bool) -> torch.Tensor:
    """One Gauss-Newton update w += num / den from the summed (F, 2) terms;
    a camera whose denominator is not above the dtype's smallest normal
    number, or whose update is not finite, keeps its angle."""
    if shared:
        terms = torch.sum(terms, dim=0, keepdim=True).expand(terms.shape)
    num, den = terms.unbind(-1)
    safe = den > torch.finfo(terms.dtype).tiny
    step = torch.where(safe, num / torch.where(safe, den, torch.ones_like(den)), 0.0)
    new = dist[:, 0] + step
    return torch.where(safe & torch.isfinite(new), new, dist[:, 0])[:, None]


def _chunk_distortion_terms(cam: BAState, X_c, x_c, vis_c, f0: float, dist, model: str,
                            huber_delta=None, robust_kind: str = "huber", cur=None,
                            round_=None):
    """One chunk's accumulands of a refit pass (:func:`_refit_terms`) at the
    distortion ``cur`` (``dist`` when None), IRLS-weighted with
    ``huber_delta`` by the residuals of the model ``dist`` the refit
    started from."""
    _, p, q, r = calc_pqr(X_c, build_K(cam.f, cam.u, f0), cam.R, cam.t)
    r = torch.where(vis_c > 0, r, torch.ones_like(r))
    if huber_delta is not None:
        res_p, res_q = _distorted_residual(cam, p, q, r, x_c, f0, dist, model)
        vis_c = vis_c * robust_weight(torch.sqrt(res_p**2 + res_q**2), huber_delta, robust_kind)
    return _refit_terms(cam, p, q, r, x_c, vis_c, f0, model, dist if cur is None else cur, round_)


def _solve_distortion_lsq(terms: torch.Tensor, shared: bool) -> torch.Tensor:
    """Distortion from the accumulated normal terms: (F, 5) -> radial
    (F, 2) by the closed-form 2x2 solve, (F, 20) -> OPENCV or fisheye
    (F, 4), (F, 72) -> thin prism (F, 8). A camera whose determinant is not
    above the dtype's smallest normal number gets zeros."""
    if terms.shape[-1] == 72:
        return _solve_distortion_lsq_n(terms, 8, shared)
    if terms.shape[-1] == 20:
        return _solve_distortion_lsq_n(terms, 4, shared)
    if shared:
        terms = torch.sum(terms, dim=0, keepdim=True).expand(terms.shape)
    a11, a12, a22, b1, b2 = terms.unbind(-1)
    det = a11 * a22 - a12 * a12
    safe = det > torch.finfo(terms.dtype).tiny
    det_s = torch.where(safe, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    k1 = torch.where(safe, (b1 * a22 - b2 * a12) / det_s, zero)
    k2 = torch.where(safe, (b2 * a11 - b1 * a12) / det_s, zero)
    return torch.stack([k1, k2], dim=-1)


def _solve_spd_batch(m: torch.Tensor, rhs: torch.Tensor):
    """(solution (F, n), ok (F,)) of the per-camera systems m x = rhs. A
    camera whose matrix has no positive trace solves the identity instead
    and is not ok, nor is one whose solution is not finite. The solve is
    ``solve_ex``: a singular matrix in the batch gives that camera a
    non-finite solution (and a nonzero ``info``), never an exception for
    the whole batch."""
    n = m.shape[-1]
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    safe = tr > torch.finfo(m.dtype).tiny
    eye = torch.eye(n, dtype=m.dtype, device=m.device)
    sol, info = torch.linalg.solve_ex(torch.where(safe[:, None, None], m, eye), rhs[..., None])
    sol = sol[..., 0]
    return sol, safe & (info == 0) & torch.isfinite(sol).all(dim=-1)


def _solve_distortion_lsq_n(terms: torch.Tensor, n: int, shared: bool) -> torch.Tensor:
    """(F, n) distortion from accumulated (F, n^2 + n) normal terms, an
    n x n solve per camera (:func:`_solve_spd_batch`); a camera that is not
    ok gets zeros, as in the JAX package."""
    nf = terms.shape[0]
    if shared:
        terms = torch.sum(terms, dim=0, keepdim=True).expand(terms.shape)
    sol, ok = _solve_spd_batch(terms[:, : n * n].reshape(nf, n, n), terms[:, n * n:])
    return torch.where(ok[:, None], sol, torch.zeros_like(sol))


def _solve_full_opencv_round(terms: torch.Tensor, dist: torch.Tensor, round_: str,
                             shared: bool) -> torch.Tensor:
    """The (F, 8) distortion after one alternation round, from its summed
    (F, 30) terms: "num" updates (k1, k2, k3, p1, p2), "den" (k4, k5, k6); a
    camera whose system is degenerate keeps its current values."""
    nf = terms.shape[0]
    if shared:
        terms = torch.sum(terms, dim=0, keepdim=True).expand(terms.shape)
    n_unk = 5 if round_ == "num" else 3
    m = terms[:, :25].reshape(nf, 5, 5)[:, :n_unk, :n_unk]
    sol, ok = _solve_spd_batch(m, terms[:, 25:25 + n_unk])
    if round_ == "num":
        cur = torch.cat([dist[:, 0:3], dist[:, 6:8]], dim=-1)
        new = torch.where(ok[:, None], sol, cur)
        return torch.cat([new[:, 0:3], dist[:, 3:6], new[:, 3:5]], dim=-1)
    new = torch.where(ok[:, None], sol, dist[:, 3:6])
    return torch.cat([dist[:, 0:3], new, dist[:, 6:8]], dim=-1)


def distort_points(x: torch.Tensor, f: torch.Tensor, u: torch.Tensor | None = None,
                   f0: float = 1.0, distortion=None, distortion_model: str | None = "auto"):
    """Pinhole image points (P, F, 2), f0-normalized, to their distorted
    positions under ``distortion`` (any family) for cameras of focal length
    f (F,) and principal point u (F, 2) (zero when None): the forward half
    of :func:`undistort_points`."""
    if distortion is None:
        return x
    u = x.new_zeros(f.shape + (2,)) if u is None else u
    model = resolve_distortion_model(distortion, distortion_model)
    g1 = x[..., 0] - _per_camera(u[..., 0] / f0)
    g2 = x[..., 1] - _per_camera(u[..., 1] / f0)
    s1, s2, _ = _distortion_shift_and_jacobian(f, u, f0, distortion, model, g1, g2)
    return x + torch.stack([s1, s2], dim=-1)


def _distortion_shift_and_jacobian(f, u, f0: float, dist, model: str, g1, g2):
    """(shift1, shift2, D) of the distortion at g: the distorted prediction
    is g + shift (+ u/f0) and D = (d11, d12, d21, d22) its exact 2x2
    Jacobian wrt g, read off the shared chain (:func:`_apply_distortion_chain`)
    fed the identity as point rows, so every model, the asymmetric thin
    prism too, takes one code path. The chain writes the camera rows in
    place, so they are fresh tensors; it reads only their first three
    columns."""
    nf = f.shape[0]
    st = BAState(X=g1.new_zeros((0, 3)), f=f, u=u, t=g1.new_zeros((nf, 3)),
                 R=torch.eye(3, dtype=g1.dtype, device=g1.device).expand(nf, 3, 3))
    p = g1 + _per_camera(u[..., 0] / f0)
    q = g2 + _per_camera(u[..., 1] / f0)
    e1 = torch.stack([torch.ones_like(g1), torch.zeros_like(g1)], dim=-1)
    e2 = e1.flip(-1)
    zero = torch.zeros_like(g1)
    s1, s2, row1, row2, _, _ = _apply_distortion_chain(
        st, p, q, torch.ones_like(g1), f0, dist, zero, zero, e1, e2,
        g1.new_zeros(g1.shape + (3,)), g1.new_zeros(g1.shape + (3,)), model)
    return s1, s2, (row1[..., 0], row1[..., 1], row2[..., 0], row2[..., 1])


def undistort_points(x: torch.Tensor, f: torch.Tensor, u: torch.Tensor | None = None,
                     f0: float = 1.0, distortion=None, distortion_model: str | None = "auto",
                     iters: int = 10) -> torch.Tensor:
    """Observed (distorted) image points (P, F, 2), f0-normalized, to their
    pinhole positions: the inverse of :func:`distort_points` for every
    family, as COLMAP's image_undistorter and cv::undistortPoints give it.
    Each point solves distort(g) = g_obs by Newton on the chain's exact
    2x2 Jacobian from g_obs, ``iters`` steps; no step reads the host."""
    if distortion is None:
        return x
    u = x.new_zeros(f.shape + (2,)) if u is None else u
    model = resolve_distortion_model(distortion, distortion_model)
    t1 = x[..., 0] - _per_camera(u[..., 0] / f0)  # the observed, distorted g
    t2 = x[..., 1] - _per_camera(u[..., 1] / f0)
    g1, g2 = t1, t2
    for _ in range(iters):
        s1, s2, (d11, d12, d21, d22) = _distortion_shift_and_jacobian(f, u, f0, distortion,
                                                                      model, g1, g2)
        r1 = g1 + s1 - t1  # the residual of distort(g) = t
        r2 = g2 + s2 - t2
        det = d11 * d22 - d12 * d21
        det = torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
        g1, g2 = g1 - (d22 * r1 - d12 * r2) / det, g2 - (d11 * r2 - d21 * r1) / det
    return torch.stack([g1 + _per_camera(u[..., 0] / f0), g2 + _per_camera(u[..., 1] / f0)],
                       dim=-1)


def _check_config(config: LMConfig, dist=None) -> str:
    """Check a run's names: an unknown loss or distortion-model name or a
    column count that does not fit the model raises ``ValueError``.
    Returns the resolved model name."""
    model = resolve_distortion_model(dist, config.distortion_model)
    resolve_robust(config.robust)
    return model


def _prepare_distortion(distortion, config: LMConfig, nf: int, lane_dims: int, dtype, device):
    """(dist, model) of a run: the caller's distortion as a (F, n) tensor
    in the problem's dtype and on its device, or the refit's zero start
    (``default_distortion``) when ``distortion_rounds > 0`` and none is
    given; dist is None for a
    pinhole run. Distortion is for one problem: with lane dimensions it
    raises ``ValueError``, as the JAX package's batched paths take none."""
    model = _check_config(config, dist=distortion)
    if distortion is None and config.distortion_rounds <= 0:
        return None, model
    if lane_dims:
        raise ValueError("distortion is for one problem; the lanes take none")
    if distortion is None:
        return default_distortion(model, nf, dtype, device), model
    return as_tensor(distortion, device, dtype), model


def lm_step(x, state: BAState, vis, free, f0: float, c, axis_name=None, dist=None,
            distortion_model: str = "auto"):
    """One damped Gauss-Newton/LM step: derivatives -> Schur solve ->
    update -> new error, through the distortion ``dist`` (held fixed; the
    model from its columns unless ``distortion_model`` names it). Returns
    (new_state, error_before, error_after). With ``axis_name`` the points
    are this rank's shard and the camera-side sums are all-reduced."""
    model = resolve_distortion_model(dist, distortion_model)
    derivs, e0 = _compute_derivs(state, x, vis, free, f0, dist, model, axis_name)
    delta_xi, delta_x = _damped_solve(derivs, c, free, axis_name)
    new = _apply_update(state, delta_xi, delta_x)
    return new, e0, _state_error(new, x, vis, f0, dist, model, axis_name)


def _lm_damping(config: LMConfig, accepted, c, nu, e_prev, e_trial, pred):
    """Next (c, nu) after one trial: the reference schedule multiplies c by
    ``scale_factor`` on a rejection; the Nielsen schedule follows the gain
    ratio ``pred`` (the predicted reduction, None under the reference
    schedule), with c <= 1e25 and nu <= 1e12 so a run of rejections stays
    finite in float32."""
    if config.damping != "nielsen":
        return torch.where(accepted, c, c * config.scale_factor), nu
    rho = (e_prev - e_trial) / pred.clamp_min(1e-30)
    shrink = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    c = torch.where(accepted, c * shrink, c * nu).clamp_max(1e25)
    nu = torch.where(accepted, torch.full_like(nu, 2.0), (nu * 2.0).clamp_max(1e12))
    return c, nu


class LMOutcome(NamedTuple):
    """What the lane LM loop returns: the final state, E, damping (c, nu)
    and iterations per lane, the stacked log (or None), and the number of
    retries the lanes took together (one host read each)."""

    state: BAState
    error: torch.Tensor
    c: torch.Tensor
    nu: torch.Tensor
    n_iter: int | torch.Tensor
    log: dict | None
    retries: int


def lm_lanes(x, state0: BAState, vis, free, f0: float, config: LMConfig, init_c=None,
             init_nu=None, dist=None, model: str | None = None,
             axis_name: str | None = None, solver=None) -> LMOutcome:
    """The Levenberg–Marquardt loop over lanes: problems stacked along the
    leading dimensions of ``state0`` (none for one problem), each with its
    own damping, accept decisions and stop, as ``vmap`` runs the JAX
    ``lm_optimize``.

    Each outer iteration builds every lane's derivative blocks, then
    retries: every lane is re-damped and re-solved from its blocks, and a
    lane that has not yet accepted takes the trial, its error and the new
    damping; a lane that has accepted or finished keeps them. The retries
    end when every lane has accepted or after ``max_inner_retries``. A lane
    that accepted nothing keeps its state and stops, as does one whose E
    moved by at most ``delta_tol``; the others go on until ``max_iter``.
    Finished lanes still pay their share of every solve and do not hold up
    the retries. One host read per retry asks whether any lane is still
    retrying and whether any will iterate again.

    Under a robust loss (IRLS) each outer iteration first reweights every
    observation of every lane from its current residuals
    (:func:`_huber_weights`); the blocks, the baseline E, every trial
    error of the retries, the accept test and the ``delta_tol`` test all
    use those weights, so the E carried and returned is the weighted one
    of the lane's last iteration, as in the JAX ``lm_optimize``.

    With ``dist`` (one problem, no lanes) every residual, block and error
    goes through the distortion model, held fixed.

    Where the JAX loop would run a lane whose E is NaN to ``max_iter``
    (``NaN <= delta_tol`` is false), this one stops it after its first
    iteration, which accepts nothing; a finite lane runs the same
    iterations in both.

    With ``axis_name`` (one problem, no lanes: ``ValueError`` otherwise)
    x, vis and state0.X are this rank's shard of the points; every E and
    camera-side sum is all-reduced, so the host reads give every rank the
    same answer and all ranks retry and stop together.

    ``solver`` takes the place of :func:`_damped_solve` in every retry,
    with its signature: ``solver(derivs, c, free, axis_name) -> (delta_xi,
    delta_x)``."""
    dt, dev = x.dtype, x.device
    solve = _damped_solve if solver is None else solver
    lanes = state0.f.shape[:-1]
    if axis_name is not None and lanes:
        raise ValueError("the sharded core takes one problem, not lanes")
    nielsen = config.damping == "nielsen"
    robust_kind = resolve_robust(config.robust)
    state = state0
    e_prev = _state_error(state0, x, vis, f0, dist, model, axis_name)
    run = torch.ones(lanes, dtype=torch.bool, device=dev)  # lanes still iterating
    history = [(state0, e_prev, run)] if config.record_log else None
    c = as_tensor(config.init_damping if init_c is None else init_c, dev, dt).expand(lanes)
    nu = as_tensor(2.0 if init_nu is None else init_nu, dev, dt).expand(lanes)
    n_iter = torch.zeros(lanes, dtype=torch.int64, device=dev)
    count = retries = 0
    while count < config.max_iter:
        vis_it = vis
        if robust_kind is not None:
            vis_it = _huber_weights(state, x, vis, f0, config.huber_delta, robust_kind, dist,
                                    model)
        derivs, e_w = _compute_derivs(state, x, vis_it, free, f0, dist, model, axis_name)
        # the accept and stop baseline: the E under this iteration's weights
        e_base = e_prev if robust_kind is None else keep(run, e_w, e_prev)
        accepted = ~run  # finished lanes take no trial
        trial, e_trial = state, e_base
        run_next, iterating = torch.zeros_like(run), False  # no retry: every lane stops
        for _ in range(config.max_inner_retries):
            retry = ~accepted
            delta_xi, delta_x = solve(derivs, c, free, axis_name)
            cand = _apply_update(state, delta_xi, delta_x)
            e_cand = _state_error(cand, x, vis_it, f0, dist, model, axis_name)
            acc_t = e_cand <= e_base
            pred = (_predicted_reduction(derivs, delta_xi, delta_x, c, axis_name) if nielsen
                    else None)
            c, nu = keep_all(retry, _lm_damping(config, acc_t, c, nu, e_base, e_cand, pred),
                             (c, nu))
            trial = keep_all(retry, cand, trial)
            e_trial = keep(retry, e_cand, e_trial)
            accepted = accepted | acc_t
            retries += 1
            # lanes that will iterate again: running, accepted, and E moved
            # by more than delta_tol (NaN counts as converged here)
            run_next = run & accepted & ~(torch.abs(e_trial - e_base) <= config.delta_tol)
            # the one host read of the retry
            retrying, iterating = torch.stack([(~accepted).any(), run_next.any()]).tolist()
            if not retrying:
                break
        del derivs, vis_it
        took = run & accepted
        state = keep_all(took, trial, state)
        # a lane that accepted nothing keeps its state and the baseline E
        e_prev = keep(took, e_trial, e_base)
        if not nielsen:
            c = keep(run, c / config.divisor, c)
        n_iter = n_iter + run
        count += 1
        if history is not None:
            history.append((state, e_prev, run))
        run = run_next
        if not iterating:
            break
    return LMOutcome(state=state, error=e_prev, c=c, nu=nu,
                     n_iter=count if not lanes else n_iter,
                     log=_stack_log(history, config.max_iter, len(lanes)), retries=retries)


def lm_optimize(x, state0: BAState, vis, free, f0: float, config: LMConfig, axis_name=None,
                init_c=None, solver=None, dist=None, init_nu=None):
    """Levenberg–Marquardt outer loop (:func:`lm_lanes`). The inner retry
    re-damps and re-solves from the same derivative blocks until the trial
    error does not exceed the current one (at most ``max_inner_retries``
    times); if no trial is accepted, the state and error stay and the loop
    stops. The reference schedule divides c by ``config.divisor`` after
    each iteration; stop when |E' - E| <= delta_tol or after max_iter.
    ``init_c``/``init_nu`` resume a previous segment's damping.
    ``solver`` replaces the damped solve of every retry
    (``solver(derivs, c, free, axis_name) -> (delta_xi, delta_x)``, the
    JAX package's hook; :func:`lm_lanes`); ``lm_step`` keeps
    :func:`_damped_solve`.

    Returns (state, error, c, nu, n_iter, log): with ``config.record_log``
    the log holds "points", "basis", "pos" and "reprojection_error" stacked
    over max_iter + 1 rows (zero past the last iteration), else None."""
    model = _check_config(config, dist)
    out = lm_lanes(x, state0, vis, free, f0, config, init_c=init_c, init_nu=init_nu, dist=dist,
                   model=model, axis_name=axis_name, solver=solver)
    return out.state, out.error, out.c, out.nu, out.n_iter, out.log


def _stack_log(history, max_iter: int, n_lane_dims: int) -> dict | None:
    """The recorded (state, E) pairs as tensors with max_iter + 1 rows on
    the axis after the lane dimensions, zero past each lane's last
    iteration, under the JAX package's log keys."""
    if history is None:
        return None
    states, errors, runs = zip(*history)
    columns = {"points": [s.X for s in states], "basis": [s.R for s in states],
               "pos": [s.t for s in states], "reprojection_error": errors}
    log = {}
    for key, rows in columns.items():
        rows = torch.stack([keep(r, v, torch.zeros_like(v)) for v, r in zip(rows, runs)],
                           dim=n_lane_dims)
        shape = list(rows.shape)
        shape[n_lane_dims] = max_iter + 1
        log[key] = rows.new_zeros(shape)
        log[key].narrow(n_lane_dims, 0, len(history)).copy_(rows)
    return log


def _prepare_problem(x, init_X, init_K, init_R, init_t, f0: float, visibility, axis: str,
                     device):
    """Tensors on the device in x's dtype, the gauge-normalized start and
    the gauge mask: (x, vis, state0, free, restore info). x is
    (..., P, F, 2) with lane dimensions first. Without a visibility mask,
    vis is a (P, 1) column that broadcasts through every masked
    reduction."""
    dev = resolve_device(device)
    dt = result_dtype(x)
    x = as_tensor(x, dev, dt)
    npts, nf = x.shape[-3], x.shape[-2]
    if visibility is None:
        vis = torch.ones((npts, 1), dtype=dt, device=dev)
    else:
        vis = as_tensor(visibility, dev, dt)
        # masked observations may hold any value; zero them so 0 * nan
        # cannot leak through the masked sums
        x = torch.where(vis[..., None] > 0, x, 0.0)
    X0, R0, t0, info = normalize_gauge(
        as_tensor(init_X, dev, dt), as_tensor(init_R, dev, dt), as_tensor(init_t, dev, dt), axis
    )
    f_in, u_in = intrinsics_from_K(as_tensor(init_K, dev, dt), f0)
    state0 = BAState(X=X0, f=f_in, u=u_in, t=t0, R=R0)
    return x, vis, state0, gauge_mask(nf, axis, dt, dev), info


def bundle_adjust(
    x,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion=None,
    init_c=None,
    init_nu=None,
    device=None,
) -> BAResult:
    """Full bundle adjustment: gauge-normalize, LM-optimize, restore.
    x (..., P, F, 2); init_K/R/t (..., F, ...); the optional visibility is
    (..., P, F). Leading dimensions are lanes, each its own problem
    (:func:`lm_lanes`); ``init_c``/``init_nu`` may be one value or one per
    lane. Runs on the card unless ``device`` says otherwise; the working
    dtype is x's. The returned ``log`` always carries the final damping
    (c, nu), so a segmented run resumes through ``init_c``/``init_nu``,
    and the retries the lanes took together (``n_solver_retries``, summed
    over every LM segment).

    ``distortion`` (one problem only): (F, 2) BAL radial (k1, k2), (F, 4)
    OPENCV (k1, k2, p1, p2) or fisheye (k1..k4), (F, 8) full OPENCV
    (k1..k6, p1, p2) or thin prism (k1..k4, p1, p2, sx1, sy1), (F, 1) FOV
    (``resolve_distortion_model`` with ``config.distortion_model``), held
    fixed unless ``config.distortion_rounds`` > 0. Then each of those
    rounds first refits it at the current geometry (:func:`fit_distortion`,
    per camera or ``distortion_shared``, under a robust loss with the IRLS
    weights of the current distorted residuals) and then runs an LM
    segment; a last segment follows the last refit. With no
    ``distortion`` the refit starts from ``default_distortion``. ``n_iter`` counts every
    segment, the log covers the last one, and the result carries the
    final ``distortion``. Distortion is invariant under the similarity
    gauge, so it is neither normalized nor restored."""
    x, vis, state0, free, info = _prepare_problem(
        x, init_X, init_K, init_R, init_t, f0, visibility, axis, device
    )
    dist, model = _prepare_distortion(distortion, config, x.shape[-2], x.dim() - 3, x.dtype,
                                      x.device)
    robust_kind = resolve_robust(config.robust)
    seg_cfg = dataclasses.replace(config, record_log=False)
    c_seg, nu_seg = init_c, init_nu
    n_seg_total = retries = 0
    for _ in range(config.distortion_rounds):
        # refit first: LM before the first refit walks the free geometry
        # into the basin that absorbs the distortion (the JAX package's
        # measurement)
        vis_fit = vis
        if robust_kind is not None:
            vis_fit = _huber_weights(state0, x, vis, f0, config.huber_delta, robust_kind, dist,
                                     model)
        dist = fit_distortion(state0, x, vis_fit, f0, shared=config.distortion_shared,
                              model=model, dist=dist)
        seg = lm_lanes(x, state0, vis, free, f0, seg_cfg, init_c=c_seg, init_nu=nu_seg,
                       dist=dist, model=model)
        state0, c_seg, nu_seg = seg.state, seg.c, seg.nu
        n_seg_total += seg.n_iter
        retries += seg.retries
    out = lm_lanes(x, state0, vis, free, f0, config, init_c=c_seg, init_nu=nu_seg, dist=dist,
                   model=model)
    final = out.state
    Xg, Rg, tg = restore_gauge(info, final.X, final.R, final.t)
    return BAResult(X=Xg, K=build_K(final.f, final.u, f0), R=Rg, t=tg, error=out.error,
                    n_iter=out.n_iter + n_seg_total,
                    log={**(out.log or {}), "c": out.c, "nu": out.nu,
                         "n_solver_retries": out.retries + retries},
                    distortion=dist)
