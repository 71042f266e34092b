"""Point-sharded covariance of a bundle-adjustment solution.

Counterpart of ``mvrecon_tpu/parallel/sharded_covariance.py``. The
covariance (``models/covariance.py``) is a map over the points plus one
camera-side reduction, so it splits over the mesh's ``points`` axis as
the BA cores do: each rank builds its block's derivative blocks (the
camera sums G and E all-reduced inside ``_compute_derivs``), one more
all-reduce completes the Schur term F^T E^-1 F of the (9F, 9F) camera
system, every rank inverts the same system, and the point marginals stay
on their rank until the blocks are gathered. The float32 contract is the
unsharded ``ba_covariance``'s: a (9F, 9F) factor that fails gives NaN
blocks, with no retry in float64.
"""

from __future__ import annotations

import torch

from ..config import LMConfig, resolve_device
from ..models.bundle_adjustment import _compute_derivs, _huber_weights, _psum
from ..models.covariance import (
    BACovariance,
    _camera_cov_from,
    _distortion_args,
    _finalize,
    _finish_schur_inverse,
    _noise_scale,
    _point_cov_from,
    _robust_args,
    _schur_product,
    _schur_terms,
)
from ..runtime.distributed import gather_array
from .mesh import bind_axes
from .sharded_ba import POINTS_AXIS, _block_start, _local_blocks


def sharded_ba_covariance(
    mesh,
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
    """:func:`models.covariance.ba_covariance` of one problem with the
    points split over the mesh's ``points`` axis: the same inputs (pass
    the converged BA state with its ``axis``), the same result up to the
    order of the sums. P is padded to a multiple of the shard count; the
    padded points are seen by no view and cut from ``point_cov``. Every
    rank gets the global result. Runs on the card unless ``device`` says
    otherwise; the working dtype is x's."""
    dev = resolve_device(device)
    x_l, X_l, vis_l, npts = _local_blocks(mesh, x, X, visibility, dev)
    x_l, state, free, info = _block_start(x_l, X_l, vis_l, K, R, t, f0, axis)
    nf = x_l.shape[1]
    huber_delta, robust_kind = _robust_args(config)
    dist, model = _distortion_args(distortion, config, nf, 0, x_l.dtype, dev)
    vis_w = vis_l
    if huber_delta is not None:
        vis_w = _huber_weights(state, x_l, vis_l, f0, huber_delta, robust_kind, dist, model)
    with bind_axes(mesh):
        derivs, e = _compute_derivs(state, x_l, vis_w, free, f0, dist, model, POINTS_AXIS)
        einv, y = _schur_terms(derivs.matE, derivs.matF)
        a_inv = _finish_schur_inverse(_psum(_schur_product(derivs.matF, y), POINTS_AXIS),
                                      derivs.matG, free)
        n_obs = _psum(torch.sum((vis_l > 0).expand(x_l.shape[:-1])), POINTS_AXIS)
    del derivs
    sigma2, scale2 = _noise_scale(e, n_obs, npts, free)
    point_cov_n = gather_array(mesh, _point_cov_from(einv, y, a_inv, scale2), (POINTS_AXIS,))
    return _finalize(point_cov_n[:npts], _camera_cov_from(a_inv, nf, scale2), info, sigma2,
                     n_obs, e)
