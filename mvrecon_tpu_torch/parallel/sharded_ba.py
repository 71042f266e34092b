"""Point-sharded bundle adjustment over the ranks of a mesh (SPMD).

Counterpart of ``mvrecon_tpu/parallel/sharded_ba.py``, for one huge scene:

- the P (points) dimension of the observations, the 3D points, the
  visibility and every per-point Schur block is split over the mesh's
  ``points`` axis, rank r holding the r-th contiguous block of the padded
  points (JAX's ``P("points")``);
- the camera parameters (9F) are replicated;
- the only traffic per LM retry is the all-reduce of the reduced camera
  system (9F, 9F) (the packed K1 accumulator in the chunked core), its
  rhs, the camera blocks, d_F and the scalar errors; every rank then
  solves the same (9F, 9F) system.

The cores are the one-device ones with ``axis_name=POINTS_AXIS``: their
``_psum`` all-reduces over the process group the running call binds to
the name (``parallel.mesh.bind_axes``). Every rank calls these functions
with the same global host arrays, moves only its own block to its device,
and gets back the global result: X is gathered by an all-reduce of a
zero-filled (P_pad, 3) buffer, so this module's collectives are
``all_reduce`` and ``broadcast`` only. ``bundle_adjust_block`` is the
dense core from a block that is already on the rank's device, and returns
the block: the sharded pipeline (``parallel/pipelines.py``) feeds it the
calibrated block without a gather between the stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..models.bundle_adjustment import (
    BAResult,
    BAState,
    _huber_weights,
    build_K,
    default_distortion,
    fit_distortion,
    gauge_mask,
    intrinsics_from_K,
    lm_optimize,
    lm_step,
    normalize_gauge,
    resolve_distortion_model,
    resolve_robust,
    restore_gauge,
)
from ..runtime.distributed import distribute_array, gather_array
from .mesh import bind_axes, mesh_shape

POINTS_AXIS = "points"


def _host(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def pad_points(x, X, vis, n_shards: int):
    """Pad the points dimension of (x (P, F, 2), X (P, 3), vis (P, F) or a
    (P, 1) column) to a multiple of ``n_shards``; numpy arrays come back
    as tensors. Padded points get vis = 0 and X = mean(X): their LM update
    is exactly zero (the unseen-point guard of the derivative build).
    Returns (x, X, vis, P)."""
    x, X, vis = (_host(a) for a in (x, X, vis))
    npts = x.shape[0]
    rem = (-npts) % n_shards
    if rem == 0:
        return x, X, vis, npts
    return (torch.cat([x, x.new_zeros((rem,) + x.shape[1:])]),
            torch.cat([X, X.mean(dim=0).expand(rem, 3)]),
            torch.cat([vis, vis.new_zeros((rem,) + vis.shape[1:])]), npts)


def _local_blocks(mesh, x, init_X, visibility, dev: torch.device):
    """This rank's block of the padded points on ``dev`` in x's dtype:
    (x_l, X_l, vis_l, P). Without a visibility mask vis is a (P, 1)
    column, zero on the padding."""
    dt = result_dtype(x)
    x = _host(x)
    vis = (torch.ones((x.shape[0], 1), dtype=dt) if visibility is None
           else _host(visibility))
    x_p, X_p, vis_p, npts = pad_points(x, _host(init_X), vis, mesh_shape(mesh)[POINTS_AXIS])
    x_l, X_l, vis_l = (as_tensor(distribute_array(mesh, (POINTS_AXIS,), a, dev), dev, dt)
                       for a in (x_p, X_p, vis_p))
    return x_l, X_l, vis_l, npts


def _block_start(x_l, X_l, vis_l, init_K, init_R, init_t, f0: float, axis: str):
    """The gauge-normalized start of a block: (x_l with its masked
    observations zeroed, state0 (the block's X, replicated cameras), free,
    restore info). The gauge comes from the cameras alone, so every rank
    normalizes its block into the same frame."""
    dev, dt = x_l.device, x_l.dtype
    x_l = torch.where(vis_l[..., None] > 0, x_l, 0.0)
    X0, R0, t0, info = normalize_gauge(as_tensor(X_l, dev, dt), as_tensor(init_R, dev, dt),
                                       as_tensor(init_t, dev, dt), axis)
    f_in, u_in = intrinsics_from_K(as_tensor(init_K, dev, dt), f0)
    state0 = BAState(X=X0, f=f_in, u=u_in, t=t0, R=R0)
    return x_l, state0, gauge_mask(x_l.shape[1], axis, dt, dev), info


def _distortion_start(distortion, config: LMConfig, nf: int, like: torch.Tensor):
    """(modelled, model, dist0): whether the run models a distortion, its
    family, and the start (``default_distortion`` when none is given)."""
    dist = None if distortion is None else as_tensor(distortion, like.device, like.dtype)
    model = resolve_distortion_model(dist, config.distortion_model)
    if dist is None:
        dist = default_distortion(model, nf, like.dtype, like.device)
    return distortion is not None or config.distortion_rounds > 0, model, dist


def _block_result(info, final: BAState, f0: float, **fields) -> BAResult:
    """A block's ``BAResult`` in the caller's frame (the gauge restore is
    pointwise): X is this rank's block."""
    X, R, t = restore_gauge(info, final.X, final.R, final.t)
    return BAResult(X=X, K=build_K(final.f, final.u, f0), R=R, t=t, **fields)


def _gathered(mesh, res: BAResult, npts: int) -> BAResult:
    """The global result on every rank: X gathered over the points axis,
    the padding cut."""
    return res._replace(X=gather_array(mesh, res.X, (POINTS_AXIS,))[:npts])


def sharded_bundle_adjust_chunked(
    mesh,
    x,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    chunk_size: int = 4096,
    init_c=None,
    init_nu=None,
    distortion=None,
    device=None,
) -> BAResult:
    """Sharding composed with chunk-streaming: the points are split over
    the mesh's ``points`` axis and each rank scans its block in chunks of
    ``chunk_size`` through the non-fused build (K1 on the card). Per LM
    retry the traffic is the all-reduce of the packed (9F, 9F) camera
    system and a few (9F,) and scalar sums. ``init_c``/``init_nu`` resume
    a segmented run; the final ones are in ``log`` with the last segment's
    retries (``n_solver_retries``).

    ``distortion`` / ``config.distortion_rounds``: any family, with the
    single-device cores' refit-first alternation; each refit pass adds one
    all-reduce of its normal terms. Runs on the card unless ``device``
    says otherwise; the working dtype is x's."""
    from ..models.bundle_adjustment_chunked import fit_distortion_chunked, lm_optimize_chunked

    dev = resolve_device(device)
    x_l, X_l, vis_l, npts = _local_blocks(mesh, x, init_X, visibility, dev)
    x_l, st0, free, info = _block_start(x_l, X_l, vis_l, init_K, init_R, init_t, f0, axis)
    dt = x_l.dtype
    c_r = as_tensor(config.init_damping if init_c is None else init_c, dev, dt)
    nu_r = as_tensor(2.0 if init_nu is None else init_nu, dev, dt)
    model_dist, model, dist0 = _distortion_start(distortion, config, x_l.shape[1], x_l)
    robust_kind = resolve_robust(config.robust)
    huber_delta = None if robust_kind is None else config.huber_delta
    dist = dist0 if model_dist else None
    n_total = 0
    with bind_axes(mesh):
        for _ in range(config.distortion_rounds):
            # refit first, exactly as bundle_adjust_chunked; the refit's
            # per-point normal terms are all-reduced over the shards
            dist = fit_distortion_chunked(
                st0, x_l, vis_l, f0, chunk_size, shared=config.distortion_shared,
                huber_delta=huber_delta, dist=dist, axis_name=POINTS_AXIS, model=model,
                robust_kind=robust_kind or "huber")
            seg_cfg = dataclasses.replace(config, record_log=False)
            st0, _, c_r, nu_r, n_seg, _, _ = lm_optimize_chunked(
                x_l, st0, vis_l, free, f0, seg_cfg, chunk_size, axis_name=POINTS_AXIS,
                init_c=c_r, init_nu=nu_r, dist=dist)
            n_total += n_seg
        final, e, c_f, nu_f, n_iter, n_retries, _ = lm_optimize_chunked(
            x_l, st0, vis_l, free, f0, config, chunk_size, axis_name=POINTS_AXIS,
            init_c=c_r, init_nu=nu_r, dist=dist)
    res = _block_result(info, final, f0, error=e, n_iter=n_iter + n_total,
                        log={"n_solver_retries": n_retries, "c": c_f, "nu": nu_f},
                        distortion=dist if model_dist else None)
    return _gathered(mesh, res, npts)


def sharded_lm_step(mesh, x, state: BAState, vis, free, c, f0: float = 1.0, device=None):
    """One damped LM step with the points split over the mesh's ``points``
    axis (derivatives -> all-reduced Schur system -> solve -> update -> new
    error), from the global x (P, F, 2), ``state`` (normalized gauge), vis
    (P, F) and gauge mask; P must split evenly over the axis. Returns the
    global (new_state, error_before, error_after) on every rank. Runs on
    the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    dt = result_dtype(x)
    x_l, vis_l, X_l = (as_tensor(distribute_array(mesh, (POINTS_AXIS,), _host(a), dev), dev, dt)
                       for a in (x, vis, state.X))
    cams = (as_tensor(a, dev, dt) for a in (state.f, state.u, state.t, state.R))
    st = BAState(X_l, *cams)
    with bind_axes(mesh):
        new, e_now, e_new = lm_step(x_l, st, vis_l, as_tensor(free, dev, dt),
                                    f0, as_tensor(c, dev, dt), POINTS_AXIS)
        X = gather_array(mesh, new.X, (POINTS_AXIS,))
    return new._replace(X=X), e_now, e_new


def sharded_bundle_adjust(
    mesh,
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
    device=None,
) -> BAResult:
    """Full bundle adjustment with the points split over the mesh's
    ``points`` axis: the semantics of ``models.bundle_adjustment.
    bundle_adjust`` for one problem (the same LM core with the axis name,
    the same distortion alternation; the point-side Schur solve always,
    as in the JAX package), P padded to a multiple of the shard count.
    ``log`` is None. Runs on the card unless ``device`` says otherwise;
    the working dtype is x's."""
    dev = resolve_device(device)
    x_l, X_l, vis_l, npts = _local_blocks(mesh, x, init_X, visibility, dev)
    res = bundle_adjust_block(mesh, x_l, X_l, vis_l, init_K, init_R, init_t, f0=f0, axis=axis,
                              config=config, distortion=distortion)
    return _gathered(mesh, res, npts)


def bundle_adjust_block(
    mesh,
    x_l: torch.Tensor,
    X_l: torch.Tensor,
    vis_l: torch.Tensor | None,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion=None,
    solver=None,
) -> BAResult:
    """:func:`sharded_bundle_adjust` from this rank's block, already on its
    device: x_l (Pl, F, 2), X_l (Pl, 3) and vis_l (Pl, F), a (Pl, 1)
    column or None (every observation seen), with the cameras replicated.
    The X of the result is the block's, in the caller's frame; nothing is
    gathered. A pipeline feeds it the calibrated block this way, so the
    point cloud is never gathered between its stages. ``solver`` goes to
    every LM segment (``lm_optimize``'s hook; the 2D BA's CG,
    ``sharded_ba_2d.py``)."""
    if vis_l is None:
        vis_l = x_l.new_ones((x_l.shape[0], 1))
    x_l, st0, free, info = _block_start(x_l, X_l, vis_l, init_K, init_R, init_t, f0, axis)
    model_dist, model, dist0 = _distortion_start(distortion, config, x_l.shape[1], x_l)
    robust_kind = resolve_robust(config.robust)
    dist = dist0 if model_dist else None
    n_total = 0
    c_seg = None
    with bind_axes(mesh):
        for _ in range(config.distortion_rounds):
            # refit first, exactly as bundle_adjust; the refit's per-point
            # normal terms are all-reduced over the shards
            vis_fit = vis_l
            if robust_kind is not None:
                vis_fit = _huber_weights(st0, x_l, vis_l, f0, config.huber_delta, robust_kind,
                                         dist, model)
            dist = fit_distortion(st0, x_l, vis_fit, f0, shared=config.distortion_shared,
                                  axis_name=POINTS_AXIS, model=model, dist=dist)
            seg_cfg = dataclasses.replace(config, record_log=False)
            st0, _, c_seg, _, n_seg, _ = lm_optimize(x_l, st0, vis_l, free, f0, seg_cfg,
                                                     axis_name=POINTS_AXIS, init_c=c_seg,
                                                     solver=solver, dist=dist)
            n_total += n_seg
        final, e, _, _, n_iter, _ = lm_optimize(x_l, st0, vis_l, free, f0, config,
                                                axis_name=POINTS_AXIS, init_c=c_seg,
                                                solver=solver, dist=dist)
    return _block_result(info, final, f0, error=e, n_iter=n_iter + n_total, log=None,
                         distortion=dist if model_dist else None)
