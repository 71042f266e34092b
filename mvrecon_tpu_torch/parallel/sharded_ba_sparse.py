"""Point-partitioned sparse (observation-list) bundle adjustment.

Counterpart of ``mvrecon_tpu/parallel/sharded_ba_sparse.py``: the
O(n_obs) core (``models/bundle_adjustment_sparse.py``) over the ranks of a
mesh's ``points`` axis, for problems whose observation list outgrows one
card. The list is sorted by point, so a contiguous range of points takes
all of its observations with it:

- rank s holds the points [s * pps, (s + 1) * pps) (pps = ceil(P / N)),
  their observations re-indexed to the block and padded with zero-weight
  observations to the longest block (``partition_sparse_obs``), and the
  points themselves; the cameras are replicated;
- the cross-rank traffic a retry is the all-reduce of the camera-side
  sums (E, the (109, F) build rows, Nielsen's two point-side sums) and one
  (9F,) all-reduce a CG iteration; the factor rows, the point blocks and
  the back-substitution never leave the rank.

Every rank calls ``sharded_bundle_adjust_sparse`` with the same global
host arrays, partitions them on the host, moves only its own block to its
device and gets the global result (X gathered by the zero-filled
all-reduce of ``runtime/distributed.gather_array``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..models.bundle_adjustment import BAResult
from ..models.bundle_adjustment_sparse import SparseObs, _adjust_list
from ..runtime.distributed import gather_array
from .mesh import bind_axes, mesh_shape
from .sharded_ba import POINTS_AXIS


def _host_list(point_idx, cam_idx, xy, weights):
    """The list as host numpy: xy (N, 2) (lane-major (2, N) accepted), the
    weights ones when None; ``ValueError`` unless sorted by point."""
    to_np = (lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a))
    point_idx, cam_idx, xy = to_np(point_idx), to_np(cam_idx), to_np(xy)
    n = point_idx.shape[0]
    if xy.shape == (2, n) and xy.shape != (n, 2):
        xy = xy.T  # accept lane-major input too
    if np.any(np.diff(point_idx) < 0):
        raise ValueError("observation list must be sorted by point_idx")
    w = np.ones(point_idx.shape, xy.dtype) if weights is None else to_np(weights)
    return point_idx, cam_idx, xy, w


def _split(point_idx: np.ndarray, n_points: int, n_shards: int):
    """(points per shard, the N + 1 observation offsets of the shards, the
    longest shard's length, at least 1): shard s owns the points [s pps,
    (s + 1) pps) and the observations between its offsets (searchsorted
    on the sorted point ids)."""
    pps = -(-n_points // n_shards)
    bounds = np.searchsorted(point_idx, np.arange(1, n_shards) * pps)
    offs = np.concatenate([[0], bounds, [point_idx.shape[0]]])
    return pps, offs, max(int(np.diff(offs).max(initial=0)), 1)


def _shard_block(point_idx, cam_idx, xy, w, n_points: int, pps: int, offs, n_max: int, s: int):
    """Shard s of the partition as numpy (point_idx (n_max,) int32 local,
    cam_idx int32, xy (2, n_max), weights): its observations, then padding
    of weight 0 that points at the shard's last point (the list stays
    sorted) and camera 0."""
    lo, hi = int(offs[s]), int(offs[s + 1])
    n = hi - lo
    pi = np.zeros(n_max, np.int32)
    ci = np.zeros(n_max, np.int32)
    xy_s = np.zeros((2, n_max), xy.dtype)
    w_s = np.zeros(n_max, xy.dtype)
    pi[:n] = point_idx[lo:hi] - s * pps
    ci[:n] = cam_idx[lo:hi]
    xy_s[:, :n] = xy[lo:hi].T
    w_s[:n] = w[lo:hi]
    pi[n:] = min(pps, n_points - s * pps) - 1 if s * pps < n_points else 0
    return pi, ci, xy_s, w_s


def partition_sparse_obs(point_idx, cam_idx, xy, n_points: int, n_shards: int, weights=None):
    """Host-side partition of a point-sorted observation list into
    ``n_shards`` equal-size blocks split at point boundaries.

    Points are split into contiguous ranges of ``ceil(P / n_shards)``;
    each shard's observations are re-indexed to shard-local point ids and
    padded with zero-weight observations (pointing at the shard's last
    point, camera 0) to the longest shard, so the stacked arrays are
    rectangular.

    Returns (obs_flat, points_per_shard): ``obs_flat`` a ``SparseObs`` of
    host tensors with flat (n_shards * n_max,) arrays, shard s owning the
    rows [s n_max, (s + 1) n_max), and ``xy`` (2, n_shards * n_max), shard
    s owning that lane block."""
    pi, ci, xy, w = _host_list(point_idx, cam_idx, xy, weights)
    pps, offs, n_max = _split(pi, n_points, n_shards)
    blocks = [_shard_block(pi, ci, xy, w, n_points, pps, offs, n_max, s)
              for s in range(n_shards)]
    pi_s, ci_s, xy_s, w_s = (np.concatenate(parts, axis=-1) for parts in zip(*blocks))
    return SparseObs(*(torch.from_numpy(np.ascontiguousarray(a))
                       for a in (pi_s, ci_s, xy_s, w_s))), pps


def sharded_bundle_adjust_sparse(
    mesh,
    point_idx,
    cam_idx,
    xy,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    weights=None,
    distortion=None,
    factor_dtype=None,
    factor_mode: str = "stored",
    device=None,
    timer=None,
) -> BAResult:
    """Sparse BA over the mesh's ``points`` axis: the semantics of
    ``models.bundle_adjustment_sparse.bundle_adjust_sparse`` on the list
    (point_idx, cam_idx, xy) sorted by point, which every rank passes
    whole, as host arrays or tensors (xy (N, 2) or (2, N)). Each rank
    moves only its block of the partition (``partition_sparse_obs``) and of
    init_X to its device; padded points (P not a multiple of the ranks)
    start at the mean of init_X and are seen by no observation, so their
    update is zero.

    ``config.distortion_rounds`` alternates the all-reduced refit with LM
    segments, Nielsen's c and nu carried across them, as the unsharded
    core. ``factor_dtype``, ``factor_mode`` and ``timer`` are
    ``bundle_adjust_sparse``'s, applied to the rank's block.
    The log holds the unsharded core's keys. ``obs_chunk`` defaults to the
    port's unsharded default (the JAX package's sharded function takes
    1 << 20), so that one rank repeats ``bundle_adjust_sparse`` exactly.
    Runs on the card unless ``device`` says otherwise; the working dtype is
    xy's."""
    dev = resolve_device(device)
    dt = result_dtype(xy)
    n_shards = mesh_shape(mesh)[POINTS_AXIS]
    s = mesh.get_local_rank(POINTS_AXIS)
    pi, ci, xy_h, w = _host_list(point_idx, cam_idx, xy, weights)
    X_h = init_X.detach().cpu() if torch.is_tensor(init_X) else torch.from_numpy(
        np.asarray(init_X))
    npts = X_h.shape[0]
    pps, offs, n_max = _split(pi, npts, n_shards)
    blk = _shard_block(pi, ci, xy_h, w, npts, pps, offs, n_max, s)
    obs = SparseObs(*(torch.from_numpy(a).to(dev) for a in blk[:2]),
                    *(as_tensor(a, dev, dt) for a in blk[2:]))
    # this rank's points, padded with the mean of all of them
    X_l = X_h[s * pps:(s + 1) * pps]
    pad = pps - X_l.shape[0]
    if pad:
        X_l = torch.cat([X_l, X_h.mean(dim=0).expand(pad, 3)])
    with bind_axes(mesh):
        return _adjust_list(
            obs, X_l, init_K, init_R, init_t, f0, axis, config, distortion,
            gather=lambda X: gather_array(mesh, X, (POINTS_AXIS,))[:npts], cg_tol=cg_tol,
            cg_max_iter=cg_max_iter, obs_chunk=obs_chunk, factor_dtype=factor_dtype,
            factor_mode=factor_mode, timer=timer, axis_name=POINTS_AXIS)
