"""Parameter covariance of a bundle-adjustment solution.

Counterpart of ``mvrecon_tpu/models/covariance.py``: the per-point 3x3 and
per-camera 9x9 covariance blocks at a BA optimum, from the Gauss-Newton
blocks the LM cores already build (``_compute_derivs``, ``_chunk_blocks``),
with one undamped Schur assembly and one Cholesky-backed (9F, 9F) inverse.

At the optimum the GN Hessian of E = sum w |res|^2 is H = 2 J^T W J with
point blocks E (P, 3, 3), coupling F (P, 3, 9F) and camera blocks G
(F, 9, 9). With i.i.d. noise of variance sigma^2 per residual component,
Cov = sigma^2 (J^T W J)^-1 = 2 sigma^2 H^-1; eliminating the points gives
A = blockdiag(G) - F^T E^-1 F and

    Sigma_cameras[f] = 2 sigma^2 (A^-1)[f, f]
    Sigma_points[i]  = 2 sigma^2 (E_i^-1 + Y_i A^-1 Y_i^T),  Y_i = E_i^-1 F_i

with sigma^2 = E / (2 n_obs - n_free), n_free = 3P + the unpinned camera
parameters. The blocks are conditional on the BA gauge (camera 0 and one
baseline component pinned; those entries are exactly zero) and are rotated
and scaled back into the caller's frame through the similarity that
``restore_gauge`` applies. Under a robust loss the IRLS weights at the
optimum multiply into W, the weighted form ceres reports.

The products (F^T E^-1 F and the lift Y A^-1 Y^T) are plain matrix
products in the working dtype; on the card TF32 is off, as the JAX
package's ``HIGHEST`` has it. A (9F, 9F) system whose Cholesky factor
fails gives NaN blocks, as ``cho_factor`` does there. ``ba_covariance``
takes leading scene dimensions as lanes (``vmap`` in the JAX package);
``ba_covariance_chunked`` streams point chunks of a device-resident
problem; ``ba_covariance_streamed`` streams them from host memory through
the streamed core's ``_ChunkFeed``. With ``distortion`` (any family, held
at the given values) the blocks are those of the distorted residuals,
plain or IRLS-weighted.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import LMConfig, as_tensor, resolve_device
from ..ops.lanes import lane_view
from ..ops.linalg import inv3x3
from ..runtime.profiling import span
from .bundle_adjustment import (
    BAState,
    _chunk_blocks,
    _compute_derivs,
    _huber_weights,
    _prepare_distortion,
    _prepare_problem,
    _reduced_camera_system,
    gauge_mask,
    intrinsics_from_K,
    normalize_gauge,
    resolve_robust,
)
from .bundle_adjustment_streamed import _ChunkFeed


class BACovariance(NamedTuple):
    point_cov: torch.Tensor  # (..., P, 3, 3), caller's frame
    camera_cov: torch.Tensor  # (..., F, 9, 9), (f, u0, v0, t, omega) order
    sigma2: torch.Tensor  # (...,) estimated per-component observation variance
    n_obs: torch.Tensor  # (...,) number of visible observations
    error: torch.Tensor  # (...,) E at the given state (weighted under a robust loss)


def _robust_args(config: LMConfig) -> tuple[float | None, str]:
    """(huber_delta, robust_kind) of the config: huber_delta is None for
    plain least squares."""
    kind = resolve_robust(config.robust)
    return (None, "huber") if kind is None else (config.huber_delta, kind)


def _distortion_args(distortion, config: LMConfig, nf: int, lane_dims: int, dtype, device):
    """(dist, model) of the given distortion, as the BA cores take it
    (``_prepare_distortion``); the covariance refits nothing, so no
    distortion means the pinhole model whatever ``distortion_rounds``
    says."""
    return _prepare_distortion(distortion, dataclasses.replace(config, distortion_rounds=0), nf,
                               lane_dims, dtype, device)


def _noise_scale(e: torch.Tensor, n_obs: torch.Tensor, npts: int, free: torch.Tensor):
    """(sigma^2, 2 sigma^2) from E over the residual degrees of freedom
    2 n_obs - n_free (at least 1)."""
    n_free = 3.0 * npts + torch.sum(free)
    sigma2 = e / torch.clamp_min(2.0 * n_obs.to(e.dtype) - n_free, 1.0)
    return sigma2, 2.0 * sigma2


def _schur_terms(matE: torch.Tensor, matF: torch.Tensor):
    """(E^-1 (..., C, 3, 3), Y = E^-1 F (..., C, 3, 9F)) of a set of points."""
    einv = inv3x3(matE)
    return einv, einv @ matF


def _schur_product(matF: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """F^T E^-1 F = sum over points of F_i^T Y_i as one (9F, 3C) x (3C, 9F)
    product per lane."""
    flat = matF.shape[:-3] + (-1, matF.shape[-1])
    return matF.reshape(flat).transpose(-1, -2) @ y.reshape(flat)


def _schur_inverse(matE, matF, matG, free):
    """(E^-1, Y, A^-1 masked): the camera-marginal machinery of the dense
    path (:func:`_finish_schur_inverse`)."""
    einv, y = _schur_terms(matE, matF)
    return einv, y, _finish_schur_inverse(_schur_product(matF, y), matG, free)


def _finish_schur_inverse(schur: torch.Tensor, matG: torch.Tensor, free: torch.Tensor):
    """A^-1 of the undamped A = blockdiag(G) - schur with the gauge-pinned
    rows and columns zeroed (their identity placeholders would read as unit
    variances). A factor that fails gives NaN for that lane's A^-1."""
    a = _reduced_camera_system(schur, matG, free)
    l, info = torch.linalg.cholesky_ex(a)
    del a
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    a_inv = torch.cholesky_solve(eye.expand(l.shape), l)
    del l
    a_inv.masked_fill_(lane_view(info != 0, a_inv), float("nan"))
    return a_inv.mul_(free[:, None]).mul_(free)


def _point_cov_from(einv, y, a_inv, scale2):
    """2 sigma^2 (E_i^-1 + Y_i A^-1 Y_i^T) per point: the lift as one
    (3C, 9F) x (9F, 9F) product per lane, then a 3 x 3 product per point."""
    lead, npts, nf9 = y.shape[:-3], y.shape[-3], y.shape[-1]
    ya = (y.reshape(lead + (3 * npts, nf9)) @ a_inv).view(y.shape)
    lift = ya @ y.transpose(-1, -2)
    return lane_view(scale2, einv) * (einv + lift)


def _camera_cov_from(a_inv, nf: int, scale2):
    """2 sigma^2 times the (9, 9) diagonal blocks of A^-1, (..., F, 9, 9)."""
    blocks = a_inv.view(a_inv.shape[:-2] + (nf, 9, nf, 9))
    diag = torch.diagonal(blocks, dim1=-4, dim2=-2).movedim(-1, -3)
    return lane_view(scale2, diag) * diag


def _global_frame_transforms(info: dict, dt):
    """(M_point (..., 3, 3), T_cam (..., 9, 9)) taking normalized-frame
    covariances to the caller's frame: points and translations by
    scale * R0, rotation perturbations by R0 (the LM update left-multiplies
    ``rodrigues(d_omega)``, a world-frame perturbation), f and the
    principal point unchanged."""
    r0 = info["R0"].to(dt)
    m_point = info["scale"].to(dt)[..., None, None] * r0
    t_cam = torch.zeros(r0.shape[:-2] + (9, 9), dtype=dt, device=r0.device)
    t_cam[..., :3, :3] = torch.eye(3, dtype=dt, device=r0.device)
    t_cam[..., 3:6, 3:6] = m_point
    t_cam[..., 6:9, 6:9] = r0
    return m_point, t_cam


def _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e) -> BACovariance:
    m_point, t_cam = _global_frame_transforms(info, point_cov_n.dtype)
    m = m_point[..., None, :, :]
    t = t_cam[..., None, :, :]
    return BACovariance(
        point_cov=m @ point_cov_n @ m.transpose(-1, -2),
        camera_cov=t @ cam_cov_n @ t.transpose(-1, -2),
        sigma2=sigma2, n_obs=n_obs, error=e,
    )


def ba_covariance(
    x,
    X,
    K,
    R,
    t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion=None,
    device=None,
) -> BACovariance:
    """Covariance blocks of a converged BA solution. The inputs mirror
    ``bundle_adjust``: pass its result (X, K, R, t) with the same ``axis``,
    so that the gauge conditioning matches the optimization's. Leading
    dimensions of x (..., P, F, 2) and the state are lanes, each its own
    problem. Runs on the card unless ``device`` says otherwise; the working
    dtype is x's. ``distortion`` (one problem) is the model of the solution, any
    family, as ``bundle_adjust`` returns it."""
    huber_delta, robust_kind = _robust_args(config)
    x, vis, state, free, info = _prepare_problem(x, X, K, R, t, f0, visibility, axis, device)
    dist, model = _distortion_args(distortion, config, x.shape[-2], x.dim() - 3, x.dtype,
                                   x.device)
    vis_w = vis
    if huber_delta is not None:
        vis_w = _huber_weights(state, x, vis, f0, huber_delta, robust_kind, dist, model)
    derivs, e = _compute_derivs(state, x, vis_w, free, f0, dist, model)
    npts, nf = x.shape[-3], x.shape[-2]
    n_obs = torch.sum((vis > 0).expand(x.shape[:-1]), dim=(-2, -1))
    sigma2, scale2 = _noise_scale(e, n_obs, npts, free)
    einv, y, a_inv = _schur_inverse(derivs.matE, derivs.matF, derivs.matG, free)
    del derivs
    point_cov_n = _point_cov_from(einv, y, a_inv, scale2)
    cam_cov_n = _camera_cov_from(a_inv, nf, scale2)
    return _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e)


def _cov_accumulate_chunk(accs, cam: BAState, X_c, x_c, vis_c, free, f0: float,
                          huber_delta=None, robust_kind: str = "huber", dist=None,
                          model: str | None = None):
    """Fold one point chunk into the undamped (schur, G, E) accumulators."""
    schur, g, e = accs
    _, _, matE, matF, matG, e_chunk = _chunk_blocks(cam, X_c, x_c, vis_c, free, f0,
                                                    huber_delta, robust_kind, dist, model)
    _, y = _schur_terms(matE, matF)
    return schur.addmm_(matF.view(-1, matF.shape[-1]).T, y.view(-1, y.shape[-1])), g + matG, e + e_chunk


def _cov_point_chunk(cam: BAState, X_c, x_c, vis_c, free, f0: float, a_inv, scale2,
                     huber_delta=None, robust_kind: str = "huber", dist=None,
                     model: str | None = None):
    """One chunk's normalized-frame point covariance blocks against the
    completed A^-1."""
    _, _, matE, matF, _, _ = _chunk_blocks(cam, X_c, x_c, vis_c, free, f0, huber_delta,
                                           robust_kind, dist, model)
    einv, y = _schur_terms(matE, matF)
    del matF
    return _point_cov_from(einv, y, a_inv, scale2)


def _zero_accs(nf: int, dt, dev):
    return (torch.zeros((9 * nf, 9 * nf), dtype=dt, device=dev),
            torch.zeros((nf, 9, 9), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev))


def ba_covariance_chunked(
    x,
    X,
    K,
    R,
    t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion=None,
    chunk_size: int = 4096,
    device=None,
) -> BACovariance:
    """:func:`ba_covariance` of one problem with O(chunk) derivative
    memory: pass 1 accumulates the camera Schur complement over point
    chunks (no (P, 3, 9F) coupling block exists), pass 2 recomputes each
    chunk's blocks for its point covariances against the shared A^-1.
    Runs on the card unless ``device`` says otherwise."""
    huber_delta, robust_kind = _robust_args(config)
    x, vis, state, free, info = _prepare_problem(x, X, K, R, t, f0, visibility, axis, device)
    npts, nf = x.shape[0], x.shape[1]
    dt, dev = x.dtype, x.device
    dist, model = _distortion_args(distortion, config, nf, 0, dt, dev)
    n_obs = torch.sum((vis > 0).expand(npts, nf))
    X0 = state.X
    pad = (-npts) % chunk_size
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        vis = torch.cat([vis, vis.new_zeros((pad,) + vis.shape[1:])])
        X0 = torch.cat([X0, X0.mean(dim=0).expand(pad, 3)])
    chunks = list(zip(X0.split(chunk_size), x.split(chunk_size), vis.split(chunk_size)))
    cam = state._replace(X=X0[:0])

    accs = _zero_accs(nf, dt, dev)
    for X_c, x_c, vis_c in chunks:
        accs = _cov_accumulate_chunk(accs, cam, X_c, x_c, vis_c, free, f0, huber_delta,
                                     robust_kind, dist, model)
    schur, g, e = accs
    del accs
    a_inv = _finish_schur_inverse(schur, g, free)
    del schur
    sigma2, scale2 = _noise_scale(e, n_obs, npts, free)
    point_cov_n = torch.cat([
        _cov_point_chunk(cam, X_c, x_c, vis_c, free, f0, a_inv, scale2, huber_delta, robust_kind,
                         dist, model)
        for X_c, x_c, vis_c in chunks])[:npts]
    cam_cov_n = _camera_cov_from(a_inv, nf, scale2)
    return _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e)


def ba_covariance_streamed(
    x_host,
    X,
    K,
    R,
    t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion=None,
    chunk_size: int = 4096,
    prefetch: int = 2,
    dtype=torch.float32,
    device=None,
    timer=None,
) -> BACovariance:
    """:func:`ba_covariance` whose observations stream from host memory:
    ``x_host`` (P, F, 2) and ``visibility`` (P, F) are NumPy arrays (or
    anything ``np.asarray`` takes) and move to the card one chunk at a
    time through ``_ChunkFeed`` (``prefetch`` chunks ahead), in two passes:
    the Schur accumulation, then the point blocks. The working dtype is
    ``dtype`` (float32 unless asked, as in the JAX package), whatever
    x_host's is. ``n_obs`` is counted from the host mask. ``timer`` (an
    ``EventTimer``) records ``pass1`` and ``pass2`` spans on the card, and
    the feed's ``h2d``, ``feed_wait`` and ``copy_wait``."""
    huber_delta, robust_kind = _robust_args(config)
    dev = resolve_device(device)
    x_host = np.asarray(x_host)
    vis_host = None if visibility is None else np.asarray(visibility)
    npts, nf = x_host.shape[0], x_host.shape[1]
    dist, model = _distortion_args(distortion, config, nf, 0, dtype, dev)
    n_obs = torch.tensor(npts * nf if vis_host is None else np.count_nonzero(vis_host > 0),
                         device=dev)

    X0, R0, t0, info = normalize_gauge(
        as_tensor(X, dev, dtype), as_tensor(R, dev, dtype), as_tensor(t, dev, dtype), axis
    )
    f_in, u_in = intrinsics_from_K(as_tensor(K, dev, dtype), f0)
    cam = BAState(X=X0[:0], f=f_in, u=u_in, t=t0, R=R0)
    free = gauge_mask(nf, axis, dtype, dev)
    feed = _ChunkFeed(x_host, vis_host, chunk_size, dtype, dev, prefetch=prefetch, timer=timer)

    def X_chunk(lo, hi):
        if hi - lo == feed.chunk:
            return X0[lo:hi]
        return torch.cat([X0[lo:hi], X0.new_zeros((feed.chunk - (hi - lo), 3))])

    with span(timer, "pass1"):
        accs = _zero_accs(nf, dtype, dev)
        for lo, hi, x_c, vis_c in feed:
            accs = _cov_accumulate_chunk(accs, cam, X_chunk(lo, hi), x_c, vis_c, free, f0,
                                         huber_delta, robust_kind, dist, model)
        schur, g, e = accs
        del accs
        a_inv = _finish_schur_inverse(schur, g, free)
        del schur
    sigma2, scale2 = _noise_scale(e, n_obs, npts, free)
    with span(timer, "pass2"):
        point_cov_n = torch.cat([
            _cov_point_chunk(cam, X_chunk(lo, hi), x_c, vis_c, free, f0, a_inv, scale2,
                             huber_delta, robust_kind, dist, model)[: hi - lo]
            for lo, hi, x_c, vis_c in feed])
    cam_cov_n = _camera_cov_from(a_inv, nf, scale2)
    return _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e)
