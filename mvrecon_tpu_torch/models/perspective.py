"""Perspective (projective) camera self-calibration.

Counterpart of ``mvrecon_tpu/models/perspective.py``: projective-depth
estimation (primary and dual methods, each with ``eig_method`` ``eigh`` or
``lowrank``, or ``power``: the depth loop's ``lowrank`` with the SVD
factorization after it, as in the JAX package), rank-4 factorization,
Euclidean upgrading through the dual absolute quadric, metric
reconstruction with the cheirality fix, and the world-axis prediction.

The bounded ``lax.while_loop``s of the JAX package are bounded Python loops
with the same stopping rules; each iteration reads its stopping scalar
once. Failure is a status value, as there.

The upgrade is not sign-equivariant, and LAPACK/cuSOLVER pick eigenvector
signs differently from XLA, so the deterministic sign fixes are kept
exactly: ``_sign_fix`` per point, the per-image sign of the chunked
Khatri–Rao branch, and the positive-trace Omega of :func:`calc_omega`.
Outputs from two backends agree in sign-invariant quantities (the
projections K [R|t] X, the reprojection error, K up to scale).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.factorization import factorization_method
from ..ops.linalg import det3x3, eigh, inv3x3, min_eigvec_sym, polar_orthogonal3
from ..ops.moments import fourth_moment_matrix, sym_expand, sym_reduce
from ..ops.rotations import unit_vec

STATUS_OK = 0
STATUS_MAX_ITER = 1  # the depth iteration hit max_iter
STATUS_OMEGA_INDEFINITE = 2  # the dual absolute quadric has no rank-3 sign case


class CalibrationResult(NamedTuple):
    X: torch.Tensor  # (P, 3)
    R: torch.Tensor  # (F, 3, 3)
    t: torch.Tensor  # (F, 3)
    K: torch.Tensor  # (F, 3, 3)
    depth_error: torch.Tensor  # final RMS reprojection error of the depth loop
    depth_iters: int
    status: int


def homogenize(x: torch.Tensor, f0: float) -> torch.Tensor:
    """(F, P, 2) -> (P, F, 3) homogeneous data (x/f0, y/f0, 1)."""
    ones = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([x / f0, ones], dim=-1).permute(1, 0, 2)


def reprojection_error(xh: torch.Tensor, m: torch.Tensor, s: torch.Tensor, f0: float) -> torch.Tensor:
    """f0 * sqrt(mean ||x - PX / (PX)_3||^2) over all (point, image) pairs."""
    npts = s.shape[1]
    px = (m @ s).reshape(-1, 3, npts).permute(2, 0, 1)  # (P, F, 3)
    px = px / px[..., 2:3]
    diff = xh - px
    return f0 * torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1)))


def _sign_fix(xi: torch.Tensor) -> torch.Tensor:
    """Flip rows whose component sum is negative."""
    return torch.where(torch.sum(xi, dim=1, keepdim=True) < 0, -xi, xi)


def _top_eigvec(mat: torch.Tensor) -> torch.Tensor:
    """Leading eigenvector of a batch of symmetric matrices (..., N, N)."""
    return eigh(mat)[1][..., -1]


def _top_eigvec_lowrank(y: torch.Tensor) -> torch.Tensor:
    """Leading eigenvector of the PSD Gram A = Y Y^T from its thin factor
    Y (..., N, r): eigh of the r x r Gram Y^T Y plus one matvec."""
    gram = torch.einsum("...na,...nb->...ab", y, y)
    vecs = eigh(gram)[1]
    xi = torch.einsum("...na,...a->...n", y, vecs[..., -1])
    return xi / torch.linalg.norm(xi, dim=-1, keepdim=True)


# Bound on the (F, 12, C) Khatri–Rao transient of the dual depth step's
# chunked Gram accumulation. Above it the (F, P, 12) factor is never
# materialized; the threshold is the JAX package's, so both packages take
# the same branch at the same shape.
_KR_CHUNK_BYTES = 256 * 1024 * 1024


def _kr_chunk(npts: int, nf: int, itemsize: int) -> int:
    """Point-chunk size holding the (F, 12, C) transient under budget
    (npts when the one-shot factor already fits)."""
    c = _KR_CHUNK_BYTES // max(1, nf * 12 * itemsize)
    if c >= npts:
        return npts
    return max(128, (c // 128) * 128)


def _kr_gram(v4: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Per-image 12x12 Grams of the Khatri–Rao factor
    Y[f, p, (k, i)] = v4[p, k] * xn[f, i, p], accumulated over point
    chunks. v4: (P, 4), xn: (F, 3, P) -> (F, 12, 12)."""
    npts = v4.shape[0]
    nf = xn.shape[0]
    chunk = _kr_chunk(npts, nf, xn.element_size())
    gram = None
    for s in range(0, npts, chunk):
        v4_c = v4[s:s + chunk]
        xn_c = xn[:, :, s:s + chunk]
        y = (v4_c.T[None, :, None, :] * xn_c[:, None, :, :]).reshape(nf, 12, -1)
        g = torch.einsum("fap,fbp->fab", y, y)
        gram = g if gram is None else gram + g
    return gram


def _kr_xi(v4: torch.Tensor, xn: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Y_f vec_f for the Khatri–Rao factor above, unnormalized -> (F, P)."""
    m = torch.einsum("fki,pk->fip", vec.reshape(-1, 4, 3), v4)
    return torch.sum(m * xn, dim=1)


def _rank4_subspace_gram(wm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Leading rank-4 left/right subspaces of wm (3F, P) from the eigh of
    the smaller Gram. Returns (u4 (3F, 4), v4 (P, 4), sigma4 (4,)),
    descending."""
    m, n = wm.shape
    tiny = torch.finfo(wm.dtype).tiny
    if m <= n:
        evals, evecs = torch.linalg.eigh(wm @ wm.T)
        u4 = evecs[:, -4:].flip(-1)
        sigma4 = torch.sqrt(evals[-4:].flip(0).clamp_min(0.0))
        v4 = (wm.T @ u4) / sigma4.clamp_min(tiny)
    else:
        evals, evecs = torch.linalg.eigh(wm.T @ wm)
        v4 = evecs[:, -4:].flip(-1)
        sigma4 = torch.sqrt(evals[-4:].flip(0).clamp_min(0.0))
        u4 = (wm @ v4) / sigma4.clamp_min(tiny)
    return u4, v4, sigma4


def _depth_step_primary(xh, z, f0: float, eig_method: str = "eigh"):
    """One primary-method depth update: per-point F x F Rayleigh-quotient
    eigenproblem over the rank-4 motion subspace."""
    npts, nf, _ = xh.shape
    w = xh * z[..., None]  # (P, F, 3)
    w = w / torch.linalg.norm(w.reshape(npts, -1), dim=1)[:, None, None]
    wm = w.reshape(npts, -1).T  # (3F, P)
    if eig_method == "lowrank":
        u4 = _rank4_subspace_gram(wm)[0]
        s = u4.T @ wm
    else:
        u, sigma, vt = torch.linalg.svd(wm, full_matrices=False)
        u4 = u[:, :4]
        s = sigma[:4, None] * vt[:4]
    m = u4
    uimg = u4.reshape(nf, 3, 4)

    xdotu = torch.einsum("pfi,fia->pfa", xh, uimg)
    xnorm = torch.linalg.norm(xh, dim=2)  # (P, F)

    if eig_method == "lowrank":
        xi = _top_eigvec_lowrank(xdotu / xnorm[..., None])
    else:
        denom = torch.einsum("pfa,pga->pfg", xdotu, xdotu)
        xi = _top_eigvec(denom / (xnorm[:, :, None] * xnorm[:, None, :]))
    z_new = _sign_fix(xi) / xnorm
    return z_new, reprojection_error(xh, m, s, f0)


def _depth_step_dual(xh, z, f0: float, eig_method: str = "eigh"):
    """One dual-method depth update: per-image P x P eigenproblem over the
    rank-4 shape subspace."""
    npts, nf, _ = xh.shape
    w = xh * z[..., None]  # (P, F, 3)
    wt = w.permute(1, 2, 0)  # (F, 3, P)
    norm_sq = torch.sum(wt * wt, dim=(1, 2))
    w = (wt / norm_sq[:, None, None]).permute(2, 0, 1)

    wm = w.reshape(npts, -1).T  # (3F, P)
    if eig_method == "lowrank":
        v4 = _rank4_subspace_gram(wm)[1]
    else:
        u, sigma, vt = torch.linalg.svd(wm, full_matrices=False)
        v4 = vt[:4].T

    xt = xh.permute(1, 2, 0)  # (F, 3, P)
    xnorm = torch.linalg.norm(xt, dim=1)  # (F, P)

    if eig_method == "lowrank":
        # B = D (V4 V4^T o X^T X) D = Y Y^T with the width-12 Khatri–Rao
        # factor Y[f, p, (k, i)] = V4[p, k] X[f, i, p] / xnorm[f, p]
        xn = xt / xnorm[:, None, :]
        if _kr_chunk(npts, nf, xh.element_size()) >= npts:
            y = v4.T[None, :, None, :] * xn[:, None, :, :]  # (F, 4, 3, P)
            xi_t = _top_eigvec_lowrank(y.reshape(nf, 12, npts).transpose(1, 2))
        else:
            vecs = eigh(_kr_gram(v4, xn))[1]
            xi_t = _kr_xi(v4, xn, vecs[..., -1])
            xi_t = xi_t / torch.linalg.norm(xi_t, dim=-1, keepdim=True)
            # per-image deterministic sign: the eigensolver's is arbitrary
            # and the per-point _sign_fix below cannot see it
            xi_t = torch.where(torch.sum(xi_t, dim=-1, keepdim=True) < 0, -xi_t, xi_t)
    else:
        v_gram = v4 @ v4.T  # (P, P)
        x_gram = torch.einsum("fip,fiq->fpq", xt, xt)  # (F, P, P)
        b = v_gram[None] * x_gram / (xnorm[:, :, None] * xnorm[:, None, :])
        xi_t = _top_eigvec(b)  # (F, P)
    z_new = _sign_fix(xi_t.T) / xnorm.T

    if eig_method == "lowrank":
        m = wm @ v4
        s = v4.T
    else:
        m = u[:, :4]
        s = sigma[:4, None] * vt[:4]
    return z_new, reprojection_error(xh, m, s, f0)


def projective_depths(
    xh: torch.Tensor,
    f0: float = 1.0,
    tolerance: float = 0.01,
    method: str = "primary",
    max_iter: int | None = None,
    eig_method: str = "eigh",
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Iterate projective depths z (P, F) until the factorization's RMS
    reprojection error < tolerance (do-while; max_iter 200 primary / 50
    dual). ``eig_method="power"`` is the JAX package's older name for
    ``"lowrank"``. Returns (z, final_error, n_iters)."""
    if max_iter is None:
        max_iter = 200 if method == "primary" else 50
    if eig_method == "power":
        eig_method = "lowrank"
    if eig_method not in ("eigh", "lowrank"):
        raise ValueError(f"unknown eig_method: {eig_method}")
    step = _depth_step_primary if method == "primary" else _depth_step_dual

    z = torch.ones(xh.shape[:2], dtype=xh.dtype, device=xh.device)
    count = 0
    while True:
        z, e = step(xh, z, f0, eig_method)
        count += 1
        # one host read per depth iteration; NaN stops like the JAX loop
        if not (float(e) >= tolerance and count < max_iter):
            return z, e, count


def _dual_quadric_basis(q: torch.Tensor) -> torch.Tensor:
    """Per-image rank-1 basis for A_cal (F, 4, 16): flattened symmetric
    4x4 matrices [Q0 Q0^T - Q1 Q1^T, sym(Q0 Q1^T), sym(Q1 Q2^T),
    sym(Q2 Q0^T)]."""
    nf = q.shape[0]
    q0, q1, q2 = q[:, 0], q[:, 1], q[:, 2]

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    def sym(a, b):
        return 0.5 * (outer(a, b) + outer(b, a))

    rows = torch.stack(
        [outer(q0, q0) - outer(q1, q1), sym(q0, q1), sym(q1, q2), sym(q2, q0)], dim=1
    )
    return rows.reshape(nf, 4, 16)


def calc_omega(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dual absolute quadric Omega from projective cameras Q (F, 3, 4).

    Returns (Omega_rank3, sigma_desc, w_rows_desc, ok): Omega after the
    rank-3 spectral correction, its eigenvalues and eigenvector rows in
    descending order, and ok False where no rank-3 sign case exists."""
    basis = _dual_quadric_basis(q)
    coeff = torch.eye(4, dtype=q.dtype, device=q.device).expand(basis.shape[0], 4, 4)
    a10 = sym_reduce(fourth_moment_matrix(basis, coeff), 4)
    omega = sym_expand(min_eigvec_sym(a10)[1], 4)
    # the constraint fixes omega up to sign: canonicalize to positive trace
    omega = omega * torch.where(torch.trace(omega) < 0, -1.0, 1.0).to(omega.dtype)

    eigval, eigvec = torch.linalg.eigh(omega)
    sigma = eigval.flip(0)
    w = eigvec.flip(1).T

    rank3_pos = torch.einsum("k,ki,kj->ij", sigma[:3], w[:3], w[:3])
    rank_neg = -torch.einsum("k,ki,kj->ij", sigma[2:], w[2:], w[2:])
    pos_case = sigma[2] > 0
    ok = pos_case | (sigma[1] < 0)
    return torch.where(pos_case, rank3_pos, rank_neg), sigma, w, ok


def _homography_from_omega(sigma: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rectifying homography H from Omega's spectrum (same case split as
    the rank-3 correction)."""
    one = torch.ones(1, dtype=sigma.dtype, device=sigma.device)
    coef_pos = torch.cat([torch.sqrt(sigma[:3].clamp_min(0.0)), one])
    coef_neg = torch.cat([one, torch.sqrt((-sigma[1:]).clamp_min(0.0))])
    pos = (coef_pos[:, None] * w).T
    neg = (coef_neg[:, None] * w).flip(0).T
    return torch.where(sigma[2] > 0, pos, neg)


def update_intrinsics(k: torch.Tensor, omega: torch.Tensor, q: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One intrinsics update from C = Q Omega Q^T: update only where
    C22 > 0 and F > 0; the per-image cost J is inf elsewhere."""
    c = torch.einsum("fia,ab,fjb->fij", q, omega, q)
    c00, c11, c22 = c[:, 0, 0], c[:, 1, 1], c[:, 2, 2]
    c02, c12, c01, c20 = c[:, 0, 2], c[:, 1, 2], c[:, 0, 1], c[:, 2, 0]

    big_f = (c00 + c11) / c22 - (c02 / c22) ** 2 - (c12 / c22) ** 2
    updatable = (c22 > 0) & (big_f > 0)

    du0 = c02 / c22
    dv0 = c12 / c22
    df = torch.sqrt((0.5 * ((c00 + c11) / c22 - du0**2 - dv0**2)).clamp_min(0.0))

    delta_k = torch.zeros_like(k)
    delta_k[:, 0, 0] = df
    delta_k[:, 1, 1] = df
    delta_k[:, 0, 2] = du0
    delta_k[:, 1, 2] = dv0
    delta_k[:, 2, 2] = 1.0

    k_updated = torch.sqrt(c22.clamp_min(0.0))[:, None, None] * (k @ delta_k)
    k_new = torch.where(updatable[:, None, None], k_updated, k)

    j_val = (
        (c00 / c22 - 1.0) ** 2
        + (c11 / c22 - 1.0) ** 2
        + 2.0 * (c01**2 + c12**2 + c20**2) / c22**2
    )
    return k_new, torch.where(updatable, j_val, torch.full_like(j_val, float("inf")))


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median with the mean of the two middle values for even counts
    (``jnp.median``'s rule; ``torch.median`` returns the lower one)."""
    s = torch.sort(v).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return s[n // 2 - 1] * 0.5 + s[n // 2] * 0.5


def euclidean_upgrading(
    p: torch.Tensor, f0: float, j_tol: float = 1e-8, max_iter: int = 100
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterate (Omega, H, K) until the median self-calibration cost stops
    improving. Returns (H, K, ok)."""
    nf = p.shape[0]
    k = (f0 * torch.eye(3, dtype=p.dtype, device=p.device)).expand(nf, 3, 3)
    h = torch.zeros((4, 4), dtype=p.dtype, device=p.device)
    ok = torch.ones((), dtype=torch.bool, device=p.device)
    j_med_prev = torch.tensor(float("inf"), dtype=p.dtype, device=p.device)
    for _ in range(max_iter):
        q = inv3x3(k) @ p  # (F, 3, 4)
        omega, sigma, w, ok = calc_omega(q)
        h = _homography_from_omega(sigma, w)
        k, j = update_intrinsics(k, omega, q)
        j_med = _median(j)
        done = (j_med < j_tol) | (j_med >= j_med_prev) | (~ok)
        j_med_prev = j_med
        if bool(done):
            break
    return h, k, ok


def metric_points(s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Euclidean points from the projective shape S (4, P) and H."""
    x = (torch.linalg.inv(h) @ s).T  # (P, 4)
    return x[:, :3] / x[:, 3:]


def metric_cameras(p: torch.Tensor, k: torch.Tensor, h: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Euclidean (R, t) from projective cameras P and the upgrade (K, H)."""
    ab = inv3x3(k) @ (p @ h)
    d = det3x3(ab[:, :, :3])
    scale = torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)  # real cube root
    ab = ab / scale[:, None, None]
    a, b = ab[:, :, :3], ab[:, :, 3]
    r = polar_orthogonal3(a).transpose(-1, -2)
    t = -torch.einsum("fij,fj->fi", r, b)
    return r, t


def cheirality_score(x: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Sum of depth signs in camera 0 (flip the scene when <= 0)."""
    x0 = (x - t[0]) @ r[0]
    return torch.sum(torch.sign(x0[:, -1]))


def metric_reconstruction(p, s, k, h) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Euclidean X, R, t from projective (P, S) and the upgrade (K, H),
    including the cheirality sign fix by camera 0."""
    x = metric_points(s, h)
    r, t = metric_cameras(p, k, h)
    flip = cheirality_score(x, r, t) <= 0
    return torch.where(flip, -x, x), r, torch.where(flip, -t, t)


def predict_world_axis(x, r, t) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-axis the scene by the mean camera x-axis and world z."""
    pred_x = unit_vec(r[:, :, 0].mean(dim=0))
    world_z = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype, device=x.device)
    pred_y = unit_vec(torch.linalg.cross(world_z, pred_x, dim=-1))
    pred_z = unit_vec(torch.linalg.cross(pred_x, pred_y, dim=-1))
    r_pred = torch.stack([pred_x, pred_y, pred_z], dim=-1)
    t_pred = t.mean(dim=0)
    return (
        (x - t_pred) @ r_pred,
        torch.einsum("ji,fjk->fik", r_pred, r),
        (t - t_pred) @ r_pred,
    )


def perspective_self_calibration(
    x,
    f0: float = 1.0,
    tol: float = 0.01,
    method: str = "primary",
    max_iter: int | None = None,
    upgrade_max_iter: int = 100,
    eig_method: str = "eigh",
    device=None,
) -> CalibrationResult:
    """Full perspective self-calibration of observations x (F, P, 2),
    ending with the ``"predict"`` world-axis correction. Runs on the card
    unless ``device`` says otherwise; the working dtype is x's."""
    from ..config import as_tensor, resolve_device, result_dtype

    if method not in ("primary", "dual"):
        raise ValueError(f"unknown method: {method}")
    x = as_tensor(x, resolve_device(device), result_dtype(x))

    xh = homogenize(x, f0)
    z, depth_err, iters = projective_depths(
        xh, f0=f0, tolerance=tol, method=method, max_iter=max_iter,
        eig_method=eig_method,
    )

    w = xh * z[..., None]  # (P, F, 3)
    wm = w.reshape(w.shape[0], -1).T
    # "power" keeps the SVD factorization here, as in the JAX package
    if eig_method == "lowrank":
        m, v4, sigma4 = _rank4_subspace_gram(wm)
        s = sigma4[:, None] * v4.T
    else:
        m, s = factorization_method(wm, n_rank=4)
    p = m.reshape(-1, 3, 4)

    h, k, ok = euclidean_upgrading(p, f0, max_iter=upgrade_max_iter)
    x3d, r, t = metric_reconstruction(p, s, k, h)
    x3d, r, t = predict_world_axis(x3d, r, t)

    depth_max = (200 if method == "primary" else 50) if max_iter is None else max_iter
    if not bool(ok):
        status = STATUS_OMEGA_INDEFINITE
    elif iters >= depth_max:
        status = STATUS_MAX_ITER
    else:
        status = STATUS_OK
    return CalibrationResult(
        X=x3d, R=r, t=t, K=k, depth_error=depth_err, depth_iters=iters, status=status
    )
