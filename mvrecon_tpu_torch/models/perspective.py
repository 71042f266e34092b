"""Perspective (projective) camera self-calibration.

Counterpart of ``mvrecon_tpu/models/perspective.py``: projective-depth
estimation (primary and dual methods, each with ``eig_method`` ``eigh`` or
``lowrank``, or ``power``: the depth loop's ``lowrank`` with the SVD
factorization after it, as in the JAX package), rank-4 factorization,
Euclidean upgrading through the dual absolute quadric, metric
reconstruction with the cheirality fix, and the world-axis prediction.

Every function takes leading scene dimensions ``...``: one scene is the
case with none, and a batch of S scenes (``parallel/batched.py``) runs as
lanes, which is what ``vmap`` makes of the JAX package's functions. The
bounded ``lax.while_loop``s are bounded Python loops with the same
stopping rules per lane: a lane that has stopped keeps its values by
``torch.where`` while the others go on, and each iteration reads once
whether any lane is still running. Failure is a per-lane status value, as
there; a scene whose observations are not finite ends with NaN outputs
and ``STATUS_OMEGA_INDEFINITE`` (the decompositions go through
``ops.linalg.eigh``/``svd``, which isolate non-finite matrices).

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

from ..config import as_tensor, resolve_device, result_dtype
from ..ops.factorization import factorization_method
from ..ops.lanes import keep
from ..ops.linalg import det3x3, eigh, inv3x3, min_eigvec_sym, polar_orthogonal3, svd
from ..ops.moments import fourth_moment_matrix, sym_expand, sym_reduce
from ..ops.rotations import unit_vec
from ..runtime.profiling import stage

STATUS_OK = 0
STATUS_MAX_ITER = 1  # the depth iteration hit max_iter
STATUS_OMEGA_INDEFINITE = 2  # the dual absolute quadric has no rank-3 sign case


class CalibrationResult(NamedTuple):
    X: torch.Tensor  # (..., P, 3)
    R: torch.Tensor  # (..., F, 3, 3)
    t: torch.Tensor  # (..., F, 3)
    K: torch.Tensor  # (..., F, 3, 3)
    depth_error: torch.Tensor  # (...,) final RMS reprojection error of the depth loop
    depth_iters: int | torch.Tensor  # an int for one scene, (...,) for a batch
    status: int | torch.Tensor  # an int for one scene, (...,) for a batch


def homogenize(x: torch.Tensor, f0: float) -> torch.Tensor:
    """(..., F, P, 2) -> (..., P, F, 3) homogeneous data (x/f0, y/f0, 1)."""
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([x / f0, ones], dim=-1).transpose(-3, -2)


def reprojection_error(xh: torch.Tensor, m: torch.Tensor, s: torch.Tensor, f0: float) -> torch.Tensor:
    """f0 * sqrt(mean ||x - PX / (PX)_3||^2) over all (point, image) pairs
    of each scene: xh (..., P, F, 3), m (..., 3F, 4), s (..., 4, P)."""
    npts = s.shape[-1]
    px = (m @ s).reshape(m.shape[:-2] + (-1, 3, npts)).movedim(-1, -3)  # (..., P, F, 3)
    px = px / px[..., 2:3]
    diff = xh - px
    return f0 * torch.sqrt(torch.mean(torch.sum(diff * diff, dim=-1), dim=(-2, -1)))


def _sign_fix(xi: torch.Tensor) -> torch.Tensor:
    """Flip rows whose component sum is negative."""
    return torch.where(torch.sum(xi, dim=-1, keepdim=True) < 0, -xi, xi)


def _top_eigvec(mat: torch.Tensor, timer=None) -> torch.Tensor:
    """Leading eigenvector of a batch of symmetric matrices (..., N, N);
    the ``eigh`` is a ``kr_eigh`` stage of ``timer``."""
    with stage(timer, "kr_eigh"):
        vecs = eigh(mat)[1]
    return vecs[..., -1]


def _top_eigvec_lowrank(y: torch.Tensor, timer=None) -> torch.Tensor:
    """Leading eigenvector of the PSD Gram A = Y Y^T from its thin factor
    Y (..., N, r): eigh of the r x r Gram Y^T Y (a ``kr_eigh`` stage of
    ``timer``) plus one matvec."""
    gram = torch.einsum("...na,...nb->...ab", y, y)
    with stage(timer, "kr_eigh"):
        vecs = eigh(gram)[1]
    xi = torch.einsum("...na,...a->...n", y, vecs[..., -1])
    return xi / torch.linalg.norm(xi, dim=-1, keepdim=True)


# Bound on the (F, 12, C) Khatri–Rao transient of the dual depth step's
# chunked Gram accumulation, per scene. Above it the (F, P, 12) factor is
# never materialized; the threshold is the JAX package's, so both packages
# take the same branch at the same shape.
_KR_CHUNK_BYTES = 256 * 1024 * 1024


def _kr_chunk(npts: int, nf: int, itemsize: int) -> int:
    """Point-chunk size holding the (F, 12, C) transient under budget
    (npts when the one-shot factor already fits)."""
    c = _KR_CHUNK_BYTES // max(1, nf * 12 * itemsize)
    if c >= npts:
        return npts
    return max(128, (c // 128) * 128)


def _kr_factor(v4: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """The Khatri–Rao factor Y[f, (k, i), p] = v4[p, k] * xn[f, i, p] of
    v4 (..., P, 4) and xn (..., F, 3, P) -> (..., F, 12, P)."""
    y = v4.transpose(-1, -2)[..., None, :, None, :] * xn[..., :, None, :, :]
    return y.reshape(y.shape[:-4] + (xn.shape[-3], 12, xn.shape[-1]))


def _kr_gram(v4: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Per-image 12x12 Grams of the Khatri–Rao factor, accumulated over
    point chunks. v4: (..., P, 4), xn: (..., F, 3, P) -> (..., F, 12, 12)."""
    npts = v4.shape[-2]
    chunk = _kr_chunk(npts, xn.shape[-3], xn.element_size())
    gram = None
    for s in range(0, npts, chunk):
        y = _kr_factor(v4[..., s:s + chunk, :], xn[..., s:s + chunk])
        g = torch.einsum("...fap,...fbp->...fab", y, y)
        gram = g if gram is None else gram + g
    return gram


def _kr_xi(v4: torch.Tensor, xn: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Y_f vec_f for the Khatri–Rao factor above, unnormalized -> (..., F, P)."""
    m = torch.einsum("...fki,...pk->...fip", vec.reshape(vec.shape[:-1] + (4, 3)), v4)
    return torch.sum(m * xn, dim=-2)


def _rank4_subspace_gram(wm: torch.Tensor, timer=None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Leading rank-4 left/right subspaces of wm (..., 3F, P) from the eigh
    of the smaller Gram (a ``subspace_eigh`` stage of ``timer``). Returns
    (u4 (..., 3F, 4), v4 (..., P, 4), sigma4 (..., 4)), descending."""
    m, n = wm.shape[-2:]
    tiny = torch.finfo(wm.dtype).tiny
    wt = wm.transpose(-1, -2)
    if m <= n:
        gram = wm @ wt
        with stage(timer, "subspace_eigh"):
            evals, evecs = eigh(gram)
        u4 = evecs[..., -4:].flip(-1)
        sigma4 = torch.sqrt(evals[..., -4:].flip(-1).clamp_min(0.0))
        v4 = (wt @ u4) / sigma4.clamp_min(tiny)[..., None, :]
    else:
        gram = wt @ wm
        with stage(timer, "subspace_eigh"):
            evals, evecs = eigh(gram)
        v4 = evecs[..., -4:].flip(-1)
        sigma4 = torch.sqrt(evals[..., -4:].flip(-1).clamp_min(0.0))
        u4 = (wm @ v4) / sigma4.clamp_min(tiny)[..., None, :]
    return u4, v4, sigma4


def _data_matrix(w: torch.Tensor) -> torch.Tensor:
    """(..., P, F, 3) -> the (..., 3F, P) measurement matrix."""
    return w.reshape(w.shape[:-2] + (-1,)).transpose(-1, -2)


def _depth_step_primary(xh, z, f0: float, eig_method: str = "eigh", timer=None):
    """One primary-method depth update: per-point F x F Rayleigh-quotient
    eigenproblem over the rank-4 motion subspace. ``timer`` takes the
    ``kr_eigh`` and ``subspace_eigh`` stages."""
    nf = xh.shape[-2]
    w = xh * z[..., None]  # (..., P, F, 3)
    w = w / torch.linalg.norm(w.reshape(w.shape[:-2] + (-1,)), dim=-1)[..., None, None]
    wm = _data_matrix(w)  # (..., 3F, P)
    if eig_method == "lowrank":
        u4 = _rank4_subspace_gram(wm, timer)[0]
        s = u4.transpose(-1, -2) @ wm
    else:
        u, sigma, vt = svd(wm)
        u4 = u[..., :4]
        s = sigma[..., :4, None] * vt[..., :4, :]
    uimg = u4.reshape(u4.shape[:-2] + (nf, 3, 4))

    xdotu = torch.einsum("...pfi,...fia->...pfa", xh, uimg)
    xnorm = torch.linalg.norm(xh, dim=-1)  # (..., P, F)

    if eig_method == "lowrank":
        xi = _top_eigvec_lowrank(xdotu / xnorm[..., None], timer)
    else:
        denom = torch.einsum("...pfa,...pga->...pfg", xdotu, xdotu)
        xi = _top_eigvec(denom / (xnorm[..., :, None] * xnorm[..., None, :]), timer)
    z_new = _sign_fix(xi) / xnorm
    return z_new, reprojection_error(xh, u4, s, f0)


def _depth_step_dual(xh, z, f0: float, eig_method: str = "eigh", timer=None):
    """One dual-method depth update: per-image P x P eigenproblem over the
    rank-4 shape subspace (the 12 x 12 Khatri-Rao Gram with ``lowrank``).
    ``timer`` takes the ``kr_eigh`` and ``subspace_eigh`` stages."""
    npts, nf = xh.shape[-3], xh.shape[-2]
    wt = (xh * z[..., None]).movedim(-3, -1)  # (..., F, 3, P)
    norm_sq = torch.sum(wt * wt, dim=(-2, -1))
    w = (wt / norm_sq[..., None, None]).movedim(-1, -3)  # (..., P, F, 3)

    wm = _data_matrix(w)  # (..., 3F, P)
    if eig_method == "lowrank":
        v4 = _rank4_subspace_gram(wm, timer)[1]
    else:
        u, sigma, vt = svd(wm)
        v4 = vt[..., :4, :].transpose(-1, -2)

    xt = xh.movedim(-3, -1)  # (..., F, 3, P)
    xnorm = torch.linalg.norm(xt, dim=-2)  # (..., F, P)

    if eig_method == "lowrank":
        # B = D (V4 V4^T o X^T X) D = Y Y^T with the width-12 Khatri–Rao
        # factor Y[f, p, (k, i)] = V4[p, k] X[f, i, p] / xnorm[f, p]
        xn = xt / xnorm[..., None, :]
        if _kr_chunk(npts, nf, xh.element_size()) >= npts:
            xi_t = _top_eigvec_lowrank(_kr_factor(v4, xn).transpose(-1, -2), timer)
        else:
            gram = _kr_gram(v4, xn)
            with stage(timer, "kr_eigh"):
                vecs = eigh(gram)[1]
            xi_t = _kr_xi(v4, xn, vecs[..., -1])
            xi_t = xi_t / torch.linalg.norm(xi_t, dim=-1, keepdim=True)
            # per-image deterministic sign: the eigensolver's is arbitrary
            # and the per-point _sign_fix below cannot see it
            xi_t = torch.where(torch.sum(xi_t, dim=-1, keepdim=True) < 0, -xi_t, xi_t)
    else:
        v_gram = v4 @ v4.transpose(-1, -2)  # (..., P, P)
        x_gram = torch.einsum("...fip,...fiq->...fpq", xt, xt)  # (..., F, P, P)
        b = v_gram[..., None, :, :] * x_gram / (xnorm[..., :, None] * xnorm[..., None, :])
        xi_t = _top_eigvec(b, timer)  # (..., F, P)
    z_new = _sign_fix(xi_t.transpose(-1, -2)) / xnorm.transpose(-1, -2)

    if eig_method == "lowrank":
        m = wm @ v4
        s = v4.transpose(-1, -2)
    else:
        m = u[..., :4]
        s = sigma[..., :4, None] * vt[..., :4, :]
    return z_new, reprojection_error(xh, m, s, f0)


def _depth_max(method: str, max_iter: int | None) -> int:
    return (200 if method == "primary" else 50) if max_iter is None else max_iter


def projective_depths(
    xh: torch.Tensor,
    f0: float = 1.0,
    tolerance: float = 0.01,
    method: str = "primary",
    max_iter: int | None = None,
    eig_method: str = "eigh",
    timer=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterate projective depths z (..., P, F) until the factorization's
    RMS reprojection error < tolerance (do-while; max_iter 200 primary / 50
    dual), each lane on its own: a lane stops when its error falls below
    the tolerance, is NaN, or its count reaches max_iter, and then keeps
    its z and error while the others go on. ``eig_method="power"`` is the
    JAX package's older name for ``"lowrank"``. Returns (z, final_error,
    n_iters), the last two per lane.

    ``timer`` (a ``StageTimer``) takes the loop, with its host read an
    iteration, as the ``projective_depths`` stage, and inside it each
    step's eigenproblems as ``kr_eigh`` (the per-point or per-image top
    eigenvector) and ``subspace_eigh`` (the rank-4 subspace Gram)."""
    max_iter = _depth_max(method, max_iter)
    if eig_method == "power":
        eig_method = "lowrank"
    if eig_method not in ("eigh", "lowrank"):
        raise ValueError(f"unknown eig_method: {eig_method}")
    step = _depth_step_primary if method == "primary" else _depth_step_dual

    batch = xh.shape[:-3]
    z = torch.ones(xh.shape[:-1], dtype=xh.dtype, device=xh.device)
    e = torch.full(batch, float("inf"), dtype=xh.dtype, device=xh.device)
    iters = torch.zeros(batch, dtype=torch.int64, device=xh.device)
    run = torch.ones(batch, dtype=torch.bool, device=xh.device)
    with stage(timer, "projective_depths"):
        for count in range(1, max_iter + 1):
            z_new, e_new = step(xh, z, f0, eig_method, timer)
            z, e = keep(run, z_new, z), keep(run, e_new, e)
            iters = iters + run
            # NaN stops a lane, as the JAX loop's (e >= tol) test does
            run = run & (e >= tolerance) & (count < max_iter)
            if not bool(run.any()):  # the one host read of the iteration
                break
    return z, e, iters


def _dual_quadric_basis(q: torch.Tensor) -> torch.Tensor:
    """Per-image rank-1 basis for A_cal (..., F, 4, 16): flattened
    symmetric 4x4 matrices [Q0 Q0^T - Q1 Q1^T, sym(Q0 Q1^T), sym(Q1 Q2^T),
    sym(Q2 Q0^T)]."""
    q0, q1, q2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    def sym(a, b):
        return 0.5 * (outer(a, b) + outer(b, a))

    rows = torch.stack(
        [outer(q0, q0) - outer(q1, q1), sym(q0, q1), sym(q1, q2), sym(q2, q0)], dim=-3
    )
    return rows.reshape(rows.shape[:-2] + (16,))


def calc_omega(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dual absolute quadric Omega from projective cameras Q (..., F, 3, 4).

    Returns (Omega_rank3, sigma_desc, w_rows_desc, ok): Omega after the
    rank-3 spectral correction, its eigenvalues and eigenvector rows in
    descending order, and ok False where no rank-3 sign case exists."""
    basis = _dual_quadric_basis(q)
    coeff = torch.eye(4, dtype=q.dtype, device=q.device).expand(basis.shape[:-2] + (4, 4))
    a10 = sym_reduce(fourth_moment_matrix(basis, coeff), 4)
    omega = sym_expand(min_eigvec_sym(a10)[1], 4)
    # the constraint fixes omega up to sign: canonicalize to positive trace
    trace = torch.diagonal(omega, dim1=-2, dim2=-1).sum(-1)
    omega = omega * torch.where(trace < 0, -1.0, 1.0).to(omega.dtype)[..., None, None]

    eigval, eigvec = eigh(omega)
    sigma = eigval.flip(-1)
    w = eigvec.flip(-1).transpose(-1, -2)

    rank3_pos = torch.einsum("...k,...ki,...kj->...ij", sigma[..., :3], w[..., :3, :],
                             w[..., :3, :])
    rank_neg = -torch.einsum("...k,...ki,...kj->...ij", sigma[..., 2:], w[..., 2:, :],
                             w[..., 2:, :])
    pos_case = sigma[..., 2] > 0
    ok = pos_case | (sigma[..., 1] < 0)
    return torch.where(pos_case[..., None, None], rank3_pos, rank_neg), sigma, w, ok


def _homography_from_omega(sigma: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rectifying homography H from Omega's spectrum (same case split as
    the rank-3 correction)."""
    one = torch.ones(sigma.shape[:-1] + (1,), dtype=sigma.dtype, device=sigma.device)
    coef_pos = torch.cat([torch.sqrt(sigma[..., :3].clamp_min(0.0)), one], dim=-1)
    coef_neg = torch.cat([one, torch.sqrt((-sigma[..., 1:]).clamp_min(0.0))], dim=-1)
    pos = (coef_pos[..., :, None] * w).transpose(-1, -2)
    neg = (coef_neg[..., :, None] * w).flip(-2).transpose(-1, -2)
    return torch.where((sigma[..., 2] > 0)[..., None, None], pos, neg)


def update_intrinsics(k: torch.Tensor, omega: torch.Tensor, q: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One intrinsics update from C = Q Omega Q^T: update only where
    C22 > 0 and F > 0; the per-image cost J is inf elsewhere."""
    c = torch.einsum("...fia,...ab,...fjb->...fij", q, omega, q)
    c00, c11, c22 = c[..., 0, 0], c[..., 1, 1], c[..., 2, 2]
    c02, c12, c01, c20 = c[..., 0, 2], c[..., 1, 2], c[..., 0, 1], c[..., 2, 0]

    big_f = (c00 + c11) / c22 - (c02 / c22) ** 2 - (c12 / c22) ** 2
    updatable = (c22 > 0) & (big_f > 0)

    du0 = c02 / c22
    dv0 = c12 / c22
    df = torch.sqrt((0.5 * ((c00 + c11) / c22 - du0**2 - dv0**2)).clamp_min(0.0))

    delta_k = torch.zeros_like(k)
    delta_k[..., 0, 0] = df
    delta_k[..., 1, 1] = df
    delta_k[..., 0, 2] = du0
    delta_k[..., 1, 2] = dv0
    delta_k[..., 2, 2] = 1.0

    k_updated = torch.sqrt(c22.clamp_min(0.0))[..., None, None] * (k @ delta_k)
    k_new = torch.where(updatable[..., None, None], k_updated, k)

    j_val = (
        (c00 / c22 - 1.0) ** 2
        + (c11 / c22 - 1.0) ** 2
        + 2.0 * (c01**2 + c12**2 + c20**2) / c22**2
    )
    return k_new, torch.where(updatable, j_val, torch.full_like(j_val, float("inf")))


def _median(v: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, with the mean of the two middle values
    for even counts (``jnp.median``'s rule; ``torch.median`` returns the
    lower one)."""
    s = torch.sort(v, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return s[..., n // 2 - 1] * 0.5 + s[..., n // 2] * 0.5


def euclidean_upgrading(
    p: torch.Tensor, f0: float, j_tol: float = 1e-8, max_iter: int = 100
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Iterate (Omega, H, K) until the median self-calibration cost stops
    improving, each lane on its own: a finished lane keeps its H, K and ok
    while the others go on. p is (..., F, 3, 4). Returns (H, K, ok)."""
    batch, nf = p.shape[:-3], p.shape[-3]
    dt, dev = p.dtype, p.device
    k = (f0 * torch.eye(3, dtype=dt, device=dev)).expand(batch + (nf, 3, 3))
    h = torch.zeros(batch + (4, 4), dtype=dt, device=dev)
    ok = torch.ones(batch, dtype=torch.bool, device=dev)
    j_med_prev = torch.full(batch, float("inf"), dtype=dt, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        run = ~done
        q = inv3x3(k) @ p  # (..., F, 3, 4)
        omega, sigma, w, ok_new = calc_omega(q)
        h = keep(run, _homography_from_omega(sigma, w), h)
        k_new, j = update_intrinsics(k, omega, q)
        k, ok = keep(run, k_new, k), keep(run, ok_new, ok)
        j_med = _median(j)
        done = done | (j_med < j_tol) | (j_med >= j_med_prev) | (~ok_new)
        j_med_prev = keep(run, j_med, j_med_prev)
        if bool(done.all()):  # the one host read of the iteration
            break
    return h, k, ok


def metric_points(s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Euclidean points (..., P, 3) from the projective shape S (..., 4, P)
    and H. A singular H gives non-finite points, as ``jnp.linalg.inv``
    does, instead of raising."""
    x = (torch.linalg.inv_ex(h).inverse @ s).transpose(-1, -2)  # (..., P, 4)
    return x[..., :3] / x[..., 3:]


def metric_cameras(p: torch.Tensor, k: torch.Tensor, h: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Euclidean (R, t) from projective cameras P and the upgrade (K, H)."""
    ab = inv3x3(k) @ (p @ h[..., None, :, :])
    d = det3x3(ab[..., :3])
    scale = torch.sign(d) * torch.abs(d) ** (1.0 / 3.0)  # real cube root
    ab = ab / scale[..., None, None]
    a, b = ab[..., :3], ab[..., 3]
    r = polar_orthogonal3(a).transpose(-1, -2)
    t = -torch.einsum("...fij,...fj->...fi", r, b)
    return r, t


def cheirality_score(x: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Sum of depth signs in camera 0 (flip the scene when <= 0)."""
    x0 = (x - t[..., None, 0, :]) @ r[..., 0, :, :]
    return torch.sum(torch.sign(x0[..., -1]), dim=-1)


def metric_reconstruction(p, s, k, h) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Euclidean X, R, t from projective (P, S) and the upgrade (K, H),
    including the cheirality sign fix by camera 0."""
    x = metric_points(s, h)
    r, t = metric_cameras(p, k, h)
    flip = (cheirality_score(x, r, t) <= 0)[..., None, None]
    return torch.where(flip, -x, x), r, torch.where(flip, -t, t)


def predict_world_axis(x, r, t) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Re-axis the scene by the mean camera x-axis and world z."""
    pred_x = unit_vec(r[..., :, :, 0].mean(dim=-2))
    world_z = torch.tensor([0.0, 0.0, 1.0], dtype=x.dtype, device=x.device).expand_as(pred_x)
    pred_y = unit_vec(torch.linalg.cross(world_z, pred_x, dim=-1))
    pred_z = unit_vec(torch.linalg.cross(pred_x, pred_y, dim=-1))
    r_pred = torch.stack([pred_x, pred_y, pred_z], dim=-1)
    t_pred = t.mean(dim=-2, keepdim=True)
    return (
        (x - t_pred) @ r_pred,
        torch.einsum("...ji,...fjk->...fik", r_pred, r),
        (t - t_pred) @ r_pred,
    )


def normalize_world_axis_first_camera(x, r, t) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Move the scene into camera 0's frame, scaled so that the baseline
    from camera 0 to camera 1 has a unit component along camera 0's y."""
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=x.dtype, device=x.device)
    s = e_y @ r[0].T @ (t[1] - t[0])
    return (
        ((x - t[0]) @ r[0]) / s,
        torch.einsum("ji,fjk->fik", r[0], r),
        ((t - t[0]) @ r[0]) / s,
    )


def correct_world_coordinates(x, r, t, method: str = "first_camera"
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The world frame by ``method``: ``"first_camera"``
    (:func:`normalize_world_axis_first_camera`) or ``"predict"``
    (:func:`predict_world_axis`)."""
    if method == "first_camera":
        return normalize_world_axis_first_camera(x, r, t)
    if method == "predict":
        return predict_world_axis(x, r, t)
    raise ValueError(f"unknown method: {method}")


def perspective_self_calibration(
    x,
    f0: float = 1.0,
    tol: float = 0.01,
    method: str = "primary",
    max_iter: int | None = None,
    upgrade_max_iter: int = 100,
    eig_method: str = "eigh",
    device=None,
    timer=None,
) -> CalibrationResult:
    """Full perspective self-calibration of observations x (..., F, P, 2),
    ending with the ``"predict"`` world-axis correction. Runs on the card
    unless ``device`` says otherwise; the working dtype is x's. With
    leading scene dimensions every scene is calibrated on its own, and
    ``status`` and ``depth_iters`` are per-scene tensors; for one scene
    they are ints. ``timer`` (a ``StageTimer``) records the stages
    ``projective_depths``, ``kr_eigh`` and ``subspace_eigh`` (see
    :func:`projective_depths`; the factorization after the loop adds a
    ``subspace_eigh`` with ``lowrank``). A timed stage synchronizes the
    device at both ends; without a timer, or inside an outer stage of a
    ``StageTimer`` not made ``nested``, each is a profiler range alone."""
    if method not in ("primary", "dual"):
        raise ValueError(f"unknown method: {method}")
    x = as_tensor(x, resolve_device(device), result_dtype(x))
    batch = x.shape[:-3]

    xh = homogenize(x, f0)
    z, depth_err, iters = projective_depths(
        xh, f0=f0, tolerance=tol, method=method, max_iter=max_iter,
        eig_method=eig_method, timer=timer,
    )

    wm = _data_matrix(xh * z[..., None])
    # "power" keeps the SVD factorization here, as in the JAX package
    if eig_method == "lowrank":
        m, v4, sigma4 = _rank4_subspace_gram(wm, timer)
        s = sigma4[..., :, None] * v4.transpose(-1, -2)
    else:
        m, s = factorization_method(wm, n_rank=4)
    p = m.reshape(m.shape[:-2] + (-1, 3, 4))

    h, k, ok = euclidean_upgrading(p, f0, max_iter=upgrade_max_iter)
    x3d, r, t = metric_reconstruction(p, s, k, h)
    x3d, r, t = predict_world_axis(x3d, r, t)

    status = torch.where(
        ~ok, STATUS_OMEGA_INDEFINITE,
        torch.where(iters >= _depth_max(method, max_iter), STATUS_MAX_ITER, STATUS_OK),
    )
    if not batch:
        status, iters = int(status), int(iters)
    return CalibrationResult(
        X=x3d, R=r, t=t, K=k, depth_error=depth_err, depth_iters=iters, status=status
    )
