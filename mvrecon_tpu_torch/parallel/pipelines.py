"""Point-sharded end-to-end reconstruction: sharded calibration, then
sharded BA.

Counterpart of ``mvrecon_tpu/parallel/pipelines.py``. The unsharded
pipelines (``models/pipelines.py``) run on one device; these split one
scene's points over the mesh's ``points`` axis for both stages. The
calibration (perspective: ``sharded_calibration.
perspective_self_calibration_block``; affine: ``sharded_affine.
affine_self_calibration_block``) leaves each rank with its block of the
points, and the dense BA core starts from that block
(``sharded_ba.bundle_adjust_block``), so the point cloud is never gathered
between the stages; X and the calibration's X are gathered once, at the
end. On the command line: ``--shard-points``.
"""

from __future__ import annotations

import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..models.pipelines import ReconstructionResult
from ..runtime.distributed import distribute_array, gather_array
from ..runtime.profiling import StageTimer, stage
from .sharded_affine import affine_self_calibration_block
from .sharded_ba import POINTS_AXIS, bundle_adjust_block
from .sharded_calibration import perspective_self_calibration_block, points_block


def sharded_euclidean_reconstruction(
    mesh,
    x,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    visibility=None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """The perspective pipeline of ``models.pipelines.
    euclidean_reconstruction`` on observations x (F, P, 2) with P split
    over the mesh's ``points`` axis in both stages: sharded
    self-calibration, then the dense sharded BA in the x-up_z-forward
    gauge. P must be divisible by the points-axis size (the calibration
    has no mask to neutralize padding). visibility, an optional (P, F)
    mask, goes to BA only. Every rank calls it with the same global
    arrays and gets the global result; ``ba_log`` is None, as the dense
    sharded core keeps no log. Runs on the card unless ``device`` says
    otherwise; the working dtype is x's. ``timer`` records the wall of
    each stage."""
    dev = resolve_device(device)
    with stage(timer, "sharded_perspective_self_calibration"):
        x_l = points_block(mesh, x, dev)  # (F, Pl, 2)
        calib = perspective_self_calibration_block(mesh, x_l, x.shape[1], f0=f0, tol=tol,
                                                   method=method)
    with stage(timer, "sharded_bundle_adjustment"):
        vis_l = None if visibility is None else as_tensor(
            distribute_array(mesh, (POINTS_AXIS,), visibility, dev), dev, result_dtype(x))
        ba = bundle_adjust_block(mesh, x_l.transpose(0, 1), calib.X, vis_l, calib.K, calib.R,
                                 calib.t, f0=f0, axis="x-up_z-forward", config=config)
    return ReconstructionResult(
        X=gather_array(mesh, ba.X, (POINTS_AXIS,)), K=ba.K, R=ba.R, t=ba.t, error=ba.error,
        n_iter=ba.n_iter, calib_X=gather_array(mesh, calib.X, (POINTS_AXIS,)),
        status=calib.status, ba_log=ba.log,
    )


def sharded_affine_reconstruction(
    mesh,
    x,
    f,
    model: str = "paraperspective",
    f0: float = 1.0,
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    visibility=None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """The affine pipeline of ``models.pipelines.affine_reconstruction``
    on observations x (F, P, 2) with focal lengths f (F,), P split over the
    mesh's ``points`` axis in both stages: sharded affine
    self-calibration, the camera start t = -3 R[:, :, 2], K = I, then the
    dense sharded BA in the x-up_z-forward gauge. P must be divisible by
    the points-axis size. ``status`` is 0 when the calibration is finite
    (its ``ok``), else 1. Every rank calls it with the same global arrays
    and gets the global result; ``ba_log`` is None. Runs on the card unless
    ``device`` says otherwise; the working dtype is x's. ``timer`` records
    the wall of each stage."""
    dev = resolve_device(device)
    with stage(timer, "sharded_affine_self_calibration"):
        x_l = points_block(mesh, x, dev)  # (F, Pl, 2)
        S_l, R, ok = affine_self_calibration_block(mesh, x_l, x.shape[1], model=model, f=f)
    t = -3.0 * R[:, :, 2]
    K = torch.eye(3, dtype=x_l.dtype, device=dev).expand(R.shape)
    with stage(timer, "sharded_bundle_adjustment"):
        vis_l = None if visibility is None else as_tensor(
            distribute_array(mesh, (POINTS_AXIS,), visibility, dev), dev, x_l.dtype)
        ba = bundle_adjust_block(mesh, x_l.transpose(0, 1), S_l, vis_l, K, R, t, f0=f0,
                                 axis="x-up_z-forward", config=config)
    return ReconstructionResult(
        X=gather_array(mesh, ba.X, (POINTS_AXIS,)), K=ba.K, R=ba.R, t=ba.t, error=ba.error,
        n_iter=ba.n_iter, calib_X=gather_array(mesh, S_l, (POINTS_AXIS,)),
        status=0 if bool(ok) else 1, ba_log=ba.log,
    )
