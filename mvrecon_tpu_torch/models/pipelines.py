"""End-to-end reconstruction pipelines.

Counterpart of ``mvrecon_tpu/models/pipelines.py``. Ported so far: the
large-scale perspective pipeline, self-calibration followed by full-scale
chunked BA, single device and without the camera bootstrap.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..runtime.profiling import StageTimer
from .bundle_adjustment_chunked import bundle_adjust_chunked
from .perspective import perspective_self_calibration


class ReconstructionResult(NamedTuple):
    X: torch.Tensor  # (P, 3)
    K: torch.Tensor  # (F, 3, 3)
    R: torch.Tensor  # (F, 3, 3)
    t: torch.Tensor  # (F, 3)
    error: torch.Tensor  # final BA reprojection error (sum of squares / f0^2)
    n_iter: int  # BA iterations
    calib_X: torch.Tensor  # pre-BA points (the self-calibration output)
    status: int  # perspective calibration status (0 = ok)
    ba_log: dict | None = None


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
    -> chunked BA in the x-up_z-forward gauge, from calibration's output.

    Runs on the card unless ``device`` says otherwise; the working dtype
    is x's. ``timer`` records the wall of each stage. The sharded
    calibration (``mesh``) and the camera bootstrap
    (``bootstrap_iters > 0``) are not ported yet and raise."""
    del bootstrap_frac  # used only by the bootstrap
    if mesh is not None:
        raise NotImplementedError("the sharded calibration is not ported yet")
    if bootstrap_iters > 0:
        raise NotImplementedError("the camera bootstrap is not ported yet")
    dev = resolve_device(device)
    x = as_tensor(x, dev, result_dtype(x))

    def stage(name):
        return timer.stage(name) if timer is not None else contextlib.nullcontext()

    with stage("perspective_self_calibration"):
        calib = perspective_self_calibration(
            x, f0=f0, tol=tol, method=method, eig_method="lowrank", device=dev
        )
    with stage("bundle_adjustment"):
        ba = bundle_adjust_chunked(
            x.transpose(0, 1), calib.X, calib.K, calib.R, calib.t,
            f0=f0, axis="x-up_z-forward", config=config, chunk_size=chunk_size,
            device=dev,
        )
    return ReconstructionResult(
        X=ba.X, K=ba.K, R=ba.R, t=ba.t, error=ba.error, n_iter=ba.n_iter,
        calib_X=calib.X, status=calib.status, ba_log=ba.log,
    )
