"""Point-sharded perspective self-calibration over the ranks of a mesh.

Counterpart of ``mvrecon_tpu/parallel/sharded_calibration.py``. The depth
loops need no SVD of the scaled observation matrix W (3F, P), only its
leading rank-4 subspace and a few scalar statistics, so with the P axis
split over the mesh's ``points`` axis:

- U4 (3F, 4) comes from an eigh of the (3F, 3F) Gram G = W W^T: each
  rank multiplies its (3F, Pl) block by itself and one all-reduce of 9F^2
  values completes G;
- the right factor rows stay local, V4_l = W_l^T U4 / sigma4;
- everything per point (the depth eigenproblems through their rank-4 and
  rank-12 factors, the reprojection residuals, the metric points) stays
  on the rank; everything per camera (the DAQ upgrade, K, the metric
  cameras) is replicated, O(F) work on every rank.

An iteration all-reduces the Gram and a few scalars; the dual method adds
the per-image norms, the (F, 12, 12) Khatri–Rao Grams and the per-image
sums of squares. Every branch reads all-reduced values only, so the ranks
take the same branches. Every rank calls the public function with the
same global host array and gets the global result; ``X`` is gathered by
the zero-filled all-reduce (``runtime/distributed.gather_array``).
``perspective_self_calibration_block`` returns this rank's X block
instead, for the sharded pipeline.

Deviation from the JAX package: its dual step solves the (F, 12, 12)
eigenproblems with ``ops.linalg.jacobi_eigh`` (a TPU workaround for tiny
batches); the port takes ``ops.linalg.eigh``, as its unsharded calibration
does. Eigenvector signs may differ between the two; the depth loop's
error and the status do not depend on them, and the calibrated scene may
land in a frame turned by one global rotation.
"""

from __future__ import annotations

import torch

from ..config import as_tensor, resolve_device, result_dtype
from ..models.bundle_adjustment import _psum
from ..models.perspective import (
    STATUS_MAX_ITER,
    STATUS_OK,
    STATUS_OMEGA_INDEFINITE,
    CalibrationResult,
    _depth_max,
    _kr_chunk,
    _kr_factor,
    _kr_gram,
    _kr_xi,
    _sign_fix,
    _top_eigvec_lowrank,
    cheirality_score,
    euclidean_upgrading,
    homogenize,
    metric_cameras,
    metric_points,
    predict_world_axis,
)
from ..ops.linalg import eigh
from ..runtime.distributed import distribute_array, gather_array
from .mesh import bind_axes, mesh_shape
from .sharded_ba import POINTS_AXIS


def _rank4_subspace(wm_l: torch.Tensor, axis_name: str | None):
    """Leading rank-4 left subspace of W (3F, P), whose rows this rank holds
    as wm_l (Pl, 3F), from the all-reduced Gram. Returns (u4 (3F, 4),
    sigma4 (4,)), descending, replicated."""
    evals, evecs = eigh(_psum(wm_l.T @ wm_l, axis_name))  # ascending
    return evecs[:, -4:].flip(-1), torch.sqrt(evals[-4:].flip(-1).clamp_min(0.0))


def _rank4_error(xh_l, wm_l, u4, f0: float, n_total: int, axis_name):
    """RMS reprojection error of the rank-4 approximation: the projected
    point U4 U4^T w_p, whose per-point scale cancels in the homogeneous
    divide."""
    nf = xh_l.shape[1]
    px = ((wm_l @ u4) @ u4.T).reshape(-1, nf, 3)
    px = px / px[..., 2:3]
    total = _psum(torch.sum((xh_l - px) ** 2), axis_name)
    return f0 * torch.sqrt(total / (n_total * nf))


def _depth_step_primary_sharded(xh_l, z_l, f0: float, n_total: int, axis_name):
    """One primary depth update: per-point work on the rank, the rank-4
    subspace from the all-reduced Gram."""
    npts_l, nf, _ = xh_l.shape
    w = xh_l * z_l[..., None]
    w = w / torch.linalg.norm(w.reshape(npts_l, -1), dim=1)[:, None, None]
    wm = w.reshape(npts_l, 3 * nf)  # rows = points
    u4, _ = _rank4_subspace(wm, axis_name)
    xdotu = torch.einsum("pfi,fia->pfa", xh_l, u4.reshape(nf, 3, 4))
    xnorm = torch.linalg.norm(xh_l, dim=2)  # (Pl, F)
    xi = _sign_fix(_top_eigvec_lowrank(xdotu / xnorm[..., None]))
    return xi / xnorm, _rank4_error(xh_l, wm, u4, f0, n_total, axis_name)


def _depth_step_dual_sharded(xh_l, z_l, f0: float, n_total: int, axis_name):
    """One dual depth update: the per-image norms, the Gram and the
    (F, 12, 12) Khatri–Rao Grams all-reduced; V4's rows and the depths
    stay on the rank. The Khatri–Rao factor is built whole or in point
    chunks by the rank's own point count (``_kr_chunk``), as the unsharded
    step decides by P; the chunked branch also fixes each image's sign by
    its all-reduced component sum."""
    npts_l, nf, _ = xh_l.shape
    wt = (xh_l * z_l[..., None]).permute(1, 2, 0)  # (F, 3, Pl)
    norm_sq = _psum(torch.sum(wt * wt, dim=(1, 2)), axis_name)  # (F,), global
    wm = (wt / norm_sq[:, None, None]).permute(2, 0, 1).reshape(npts_l, 3 * nf)
    u4, sigma4 = _rank4_subspace(wm, axis_name)
    v4_l = (wm @ u4) / sigma4  # (Pl, 4)

    xt = xh_l.permute(1, 2, 0)  # (F, 3, Pl)
    xnorm = torch.linalg.norm(xt, dim=1)  # (F, Pl)
    xn = xt / xnorm[:, None, :]
    chunked = _kr_chunk(npts_l, nf, xh_l.element_size()) < npts_l
    if chunked:
        vecs = eigh(_psum(_kr_gram(v4_l, xn), axis_name))[1]
        xi_t = _kr_xi(v4_l, xn, vecs[..., -1])
    else:
        y = _kr_factor(v4_l, xn)  # (F, 12, Pl)
        vecs = eigh(_psum(y @ y.transpose(1, 2), axis_name))[1]
        xi_t = (vecs[..., -1][:, None, :] @ y)[:, 0]  # (F, Pl)
    xi_t = xi_t / torch.sqrt(_psum(torch.sum(xi_t * xi_t, dim=-1), axis_name))[:, None]
    if chunked:
        # the eigensolver's per-image sign is arbitrary and the per-point
        # _sign_fix below cannot see it
        flip = _psum(torch.sum(xi_t, dim=-1), axis_name) < 0
        xi_t = torch.where(flip[:, None], -xi_t, xi_t)
    z_new = _sign_fix(xi_t.T) / xnorm.T
    return z_new, _rank4_error(xh_l, wm, u4, f0, n_total, axis_name)


def _depth_loop(xh_l, f0: float, tol: float, method: str, max_iter: int, n_total: int,
                axis_name):
    """Do-while over the depth steps with the stopping rule of
    ``models.perspective.projective_depths``: run while the error is at or
    above ``tol`` (NaN stops) and fewer than ``max_iter`` steps ran. The
    error is all-reduced, so every rank reads the same value once an
    iteration. Returns (z_l, error, iterations)."""
    step = _depth_step_primary_sharded if method == "primary" else _depth_step_dual_sharded
    z = torch.ones(xh_l.shape[:2], dtype=xh_l.dtype, device=xh_l.device)
    count = 0
    while True:
        z, e = step(xh_l, z, f0, n_total, axis_name)
        count += 1
        if not (float(e) >= tol and count < max_iter):
            return z, e, count


def _calibrate_local(xh_l, f0: float, tol: float, method: str, max_iter: int,
                     upgrade_max_iter: int, n_total: int, axis_name):
    """The whole calibration with this rank's points and replicated
    cameras, stage by stage as ``models.perspective.
    perspective_self_calibration``; X stays on the rank."""
    z, depth_err, iters = _depth_loop(xh_l, f0, tol, method, max_iter, n_total, axis_name)
    nf = xh_l.shape[1]
    wm = (xh_l * z[..., None]).reshape(xh_l.shape[0], -1)  # (Pl, 3F)
    u4, _ = _rank4_subspace(wm, axis_name)
    p = u4.reshape(nf, 3, 4)
    h, k, ok = euclidean_upgrading(p, f0, max_iter=upgrade_max_iter)  # replicated
    x_l = metric_points((wm @ u4).T, h)  # (Pl, 3)
    r, t = metric_cameras(p, k, h)
    flip = _psum(cheirality_score(x_l, r, t), axis_name) <= 0
    x_l = torch.where(flip, -x_l, x_l)
    t = torch.where(flip, -t, t)
    x_l, r, t = predict_world_axis(x_l, r, t)  # camera-side means; X local
    if not bool(ok):
        status = STATUS_OMEGA_INDEFINITE
    else:
        status = STATUS_MAX_ITER if iters >= max_iter else STATUS_OK
    return CalibrationResult(X=x_l, R=r, t=t, K=k, depth_error=depth_err, depth_iters=iters,
                             status=status)


def points_block(mesh, x, device=None) -> torch.Tensor:
    """This rank's block (F, Pl, 2) of observations x (F, P, 2) on its
    device (``device``, default the card) in x's dtype. The calibration
    keeps the reference's full-visibility contract, so P must divide by
    the points-axis size: there is no mask to neutralize padding, and the
    Gram must not see it."""
    n_shards = mesh_shape(mesh)[POINTS_AXIS]
    npts = x.shape[1]
    if npts % n_shards:
        raise ValueError(f"P={npts} must be divisible by the points-axis size {n_shards} "
                         "(calibration has no visibility channel to mask padding)")
    dev = resolve_device(device)
    return as_tensor(distribute_array(mesh, (None, POINTS_AXIS), x, dev), dev, result_dtype(x))


def perspective_self_calibration_block(
    mesh,
    x_l: torch.Tensor,
    n_points: int,
    f0: float = 1.0,
    tol: float = 0.01,
    method: str = "dual",
    max_iter: int | None = None,
    upgrade_max_iter: int = 100,
) -> CalibrationResult:
    """:func:`sharded_perspective_self_calibration` from this rank's block
    x_l (F, Pl, 2) (``points_block``) of ``n_points`` in all. The X of the
    result is the block's (Pl, 3); nothing is gathered."""
    if method not in ("primary", "dual"):
        raise ValueError(f"unknown method: {method}")
    with bind_axes(mesh):
        return _calibrate_local(homogenize(x_l, f0), f0, tol, method,
                                _depth_max(method, max_iter), upgrade_max_iter, n_points,
                                POINTS_AXIS)


def sharded_perspective_self_calibration(
    mesh,
    x,
    f0: float = 1.0,
    tol: float = 0.01,
    method: str = "dual",
    max_iter: int | None = None,
    upgrade_max_iter: int = 100,
    device=None,
) -> CalibrationResult:
    """Perspective self-calibration with the P axis of the observations x
    (F, P, 2) split over the mesh's ``points`` axis (``max_iter``: 200 for
    primary, 50 for dual). P must be divisible by the points-axis size
    (``ValueError`` otherwise). Returns the global result on every rank:
    ``depth_iters`` and ``status`` are ints, as for one unsharded scene.
    Runs on the card unless ``device`` says otherwise; the working dtype
    is x's."""
    x_l = points_block(mesh, x, device)
    calib = perspective_self_calibration_block(mesh, x_l, x.shape[1], f0=f0, tol=tol,
                                               method=method, max_iter=max_iter,
                                               upgrade_max_iter=upgrade_max_iter)
    return calib._replace(X=gather_array(mesh, calib.X, (POINTS_AXIS,)))
