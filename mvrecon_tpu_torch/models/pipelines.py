"""End-to-end reconstruction pipelines.

Counterpart of ``mvrecon_tpu/models/pipelines.py``: the affine pipeline
(affine self-calibration, then dense BA), the perspective pipeline
(self-calibration, then dense BA) and its large-scale variant
(self-calibration, an optional camera bootstrap on a point subsample, then
chunked BA), on one device. Each stage is a range of the profiler trace
(``runtime/profiling.stage``) under the JAX package's name, and its wall
goes to an optional ``StageTimer``. The affine and the dense
perspective pipeline take leading scene dimensions, which run as lanes
(``parallel/batched.py``). The large pipeline can calibrate with the
points split over a mesh (``mesh``; ``parallel/sharded_calibration.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..ops.triangulation import triangulate
from ..runtime.profiling import StageTimer, stage
from .affine import affine_self_calibration
from .bundle_adjustment import bundle_adjust
from .bundle_adjustment_chunked import bundle_adjust_chunked
from .perspective import perspective_self_calibration


class ReconstructionResult(NamedTuple):
    """One scene's reconstruction, or S scenes' with a leading axis on
    every field (``error``, ``n_iter`` and ``status`` then (S,) tensors)."""

    X: torch.Tensor  # (..., P, 3)
    K: torch.Tensor  # (..., F, 3, 3)
    R: torch.Tensor  # (..., F, 3, 3)
    t: torch.Tensor  # (..., F, 3)
    error: torch.Tensor  # final BA reprojection error (sum of squares / f0^2)
    n_iter: int | torch.Tensor  # BA iterations
    calib_X: torch.Tensor  # pre-BA points (the self-calibration output)
    status: int | torch.Tensor  # perspective calibration status (0 = ok); 0 for affine
    ba_log: dict | None = None


def affine_reconstruction(
    x,
    f,
    model: str = "paraperspective",
    f0: float = 1.0,
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    visibility=None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """Affine pipeline on observations x (..., F, P, 2) with focal lengths
    f (..., F) (used by the paraperspective model): affine
    self-calibration -> the heuristic camera start t = -3 R[:, :, 2],
    K = I -> dense BA in the x-up_z-forward gauge.

    The calibration pins the sign of each SVD column (``canonical_signs``,
    the convention of the JAX package's point-sharded affine path) where
    the JAX ``affine_reconstruction`` keeps its backend's. An odd number
    of flipped columns mirrors the affine solution, a branch that BA does
    not leave within 50 iterations, and LAPACK, MKL and cuSOLVER pick the
    signs differently, so only a pinned convention makes the card and the
    CPU take one branch.

    visibility, an optional (P, F) mask, is honored by BA only: the
    calibration keeps the full-visibility contract, so masked x entries
    need finite placeholders. Leading scene dimensions run as lanes. Runs
    on the card unless ``device`` says otherwise; the working dtype is
    x's. ``timer`` records the wall of each stage."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))
    with stage(timer, "affine_self_calibration"):
        S, R = affine_self_calibration(x, model=model, f=f, canonical_signs=True, device=dev)
    t = -3.0 * R[..., :, :, 2]
    K = torch.eye(3, dtype=x.dtype, device=dev).expand(R.shape)
    with stage(timer, "bundle_adjustment"):
        ba = bundle_adjust(
            x.transpose(-3, -2), S, K, R, t, f0=f0, visibility=visibility,
            axis="x-up_z-forward", config=config, device=dev,
        )
    batch = x.shape[:-3]
    status = torch.zeros(batch, dtype=torch.int64, device=dev) if batch else 0
    return ReconstructionResult(
        X=ba.X, K=ba.K, R=ba.R, t=ba.t, error=ba.error, n_iter=ba.n_iter,
        calib_X=S, status=status, ba_log=ba.log,
    )


def euclidean_reconstruction(
    x,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    eig_method: str = "eigh",
    visibility=None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """Perspective pipeline on observations x (..., F, P, 2):
    self-calibration (projective depths and the metric upgrade) -> dense
    BA in the x-up_z-forward gauge, from calibration's output.

    visibility, an optional (P, F) mask, is honored by BA only: the
    calibration keeps the full-visibility contract, so masked x entries
    need finite placeholders. Leading scene dimensions run as lanes. Runs
    on the card unless ``device`` says otherwise; the working dtype is
    x's. ``timer`` records the wall of each stage; the calibration's own
    stages inside it (``perspective_self_calibration``) are timed too when
    the timer is a ``StageTimer(nested=True)``, and are profiler ranges
    otherwise."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))
    with stage(timer, "perspective_self_calibration"):
        calib = perspective_self_calibration(
            x, f0=f0, tol=tol, method=method, eig_method=eig_method, device=dev, timer=timer
        )
    with stage(timer, "bundle_adjustment"):
        ba = bundle_adjust(
            x.transpose(-3, -2), calib.X, calib.K, calib.R, calib.t, f0=f0,
            visibility=visibility, axis="x-up_z-forward", config=config, device=dev,
        )
    return ReconstructionResult(
        X=ba.X, K=ba.K, R=ba.R, t=ba.t, error=ba.error, n_iter=ba.n_iter,
        calib_X=calib.X, status=calib.status, ba_log=ba.log,
    )


def euclidean_reconstruction_large(
    x,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(
        scale_factor=4.0, delta_tol=0.0, max_iter=6,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
    ),
    chunk_size: int = 768,
    bootstrap_frac: float = 0.1,
    bootstrap_iters: int = 0,
    mesh=None,
    device=None,
    timer: StageTimer | None = None,
) -> ReconstructionResult:
    """Large-scale perspective pipeline on observations x (F, P, 2):
    self-calibration (Gram-subspace depth loop, chunked Khatri–Rao Grams)
    -> [camera bootstrap] -> chunked BA in the x-up_z-forward gauge.

    ``bootstrap_iters > 0`` first converges the cameras on a strided
    ``bootstrap_frac`` point subsample (chunked BA under the Nielsen
    schedule) and DLT re-triangulates all points from those cameras, the
    recovery path for weak starts. Give it enough iterations to converge:
    an under-converged bootstrap makes the re-triangulated points far
    worse than calibration's. ``config`` (a robust loss included) drives
    the final BA only; the bootstrap keeps its own plain-loss schedule, as
    in the JAX package.

    With ``mesh`` the calibration runs with the points split over its
    ``points`` axis (``parallel.sharded_calibration.
    sharded_perspective_self_calibration``, P divisible by the axis size),
    and every rank gets its global result. Only the calibration is
    sharded, as in the JAX package: every rank then runs the bootstrap and
    the chunked BA whole, the fused build and K2 included, and returns the
    same result, so at N ranks the BA costs N times its device time.

    Runs on the card unless ``device`` says otherwise; the working dtype
    is x's. ``timer`` records the wall of each stage."""
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))

    with stage(timer, "perspective_self_calibration"):
        if mesh is not None:
            from ..parallel.sharded_calibration import sharded_perspective_self_calibration

            calib = sharded_perspective_self_calibration(mesh, x, f0=f0, tol=tol, method=method,
                                                         device=dev)
        else:
            calib = perspective_self_calibration(
                x, f0=f0, tol=tol, method=method, eig_method="lowrank", device=dev
            )
    n_points = x.shape[1]
    x_pf = x.transpose(0, 1)  # (P, F, 2)
    X_init, K_init, R_init, t_init = calib.X, calib.K, calib.R, calib.t
    if bootstrap_iters > 0:
        with stage(timer, "camera_bootstrap_ba"):
            sub = max(int(n_points * bootstrap_frac), min(n_points, 200))
            stride = max(n_points // sub, 1)
            idx = torch.arange(0, stride * sub, stride, device=dev)
            boot_cfg = LMConfig(
                scale_factor=4.0, delta_tol=0.0, max_iter=bootstrap_iters,
                accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
            )
            boot = bundle_adjust_chunked(
                x_pf[idx], calib.X[idx], calib.K, calib.R, calib.t, f0=f0,
                axis="x-up_z-forward", config=boot_cfg, chunk_size=min(chunk_size, sub),
                device=dev,
            )
        with stage(timer, "retriangulate"):
            X_init = triangulate(x, boot.K, boot.R, boot.t, f0=f0)
        K_init, R_init, t_init = boot.K, boot.R, boot.t
    with stage(timer, "bundle_adjustment"):
        ba = bundle_adjust_chunked(
            x_pf, X_init, K_init, R_init, t_init,
            f0=f0, axis="x-up_z-forward", config=config, chunk_size=chunk_size,
            device=dev,
        )
    return ReconstructionResult(
        X=ba.X, K=ba.K, R=ba.R, t=ba.t, error=ba.error, n_iter=ba.n_iter,
        calib_X=calib.X, status=calib.status, ba_log=ba.log,
    )
