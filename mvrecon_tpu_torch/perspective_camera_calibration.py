"""Reference-named ``perspective_camera_calibration`` module (counterpart
of ``mvrecon_tpu/perspective_camera_calibration.py``).
``perspective_self_calibration(x_list, f0, tol, method)`` returns
(X, R, t, K) as the reference does; ``perspective_self_calibration_full``
returns the whole ``CalibrationResult`` with its status. Observations are
a list of (P, 2) arrays or one (F, P, 2) array; results are tensors on the
card unless ``device`` says otherwise.
"""

from __future__ import annotations

import warnings

from .affine_camera_calibration import _as_dense
from .models.perspective import (
    STATUS_MAX_ITER,
    STATUS_OMEGA_INDEFINITE,
    CalibrationResult,
    correct_world_coordinates,  # noqa: F401 (reference API)
)
from .models.perspective import perspective_self_calibration as _core


def perspective_self_calibration_full(
    x_list, f0: float = 1.0, tol: float = 0.01, method: str = "primary",
    eig_method: str = "eigh", device=None,
) -> CalibrationResult:
    """The calibration with its depth-loop diagnostics and status."""
    x = _as_dense(x_list, device)
    return _core(x, f0=f0, tol=tol, method=method, eig_method=eig_method, device=x.device)


def perspective_self_calibration(
    x_list, f0: float = 1.0, tol: float = 0.01, method: str = "primary",
    eig_method: str = "eigh", device=None,
):
    """(X, R, t, K). Raises ``ValueError`` if the metric upgrade met an
    indefinite dual absolute quadric, and warns if the depth iteration
    stopped at its limit before the tolerance, as the reference does."""
    res = perspective_self_calibration_full(x_list, f0=f0, tol=tol, method=method,
                                            eig_method=eig_method, device=device)
    if res.status == STATUS_OMEGA_INDEFINITE:
        raise ValueError("dual absolute quadric has indefinite spectrum")
    if res.status == STATUS_MAX_ITER:
        warnings.warn(
            "projective depth iteration hit max_iter without reaching the "
            f"tolerance (final error {float(res.depth_error):.3e})",
            RuntimeWarning, stacklevel=2)
    return res.X, res.R, res.t, res.K
