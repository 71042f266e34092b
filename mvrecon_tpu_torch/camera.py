"""Reference-named ``camera`` module (counterpart of
``mvrecon_tpu/camera.py``): a ``Camera`` class and the helpers
``calc_projected_points`` and ``get_camera_parames``, over the batched
functions of ``geometry/camera.py``. Inputs are numpy arrays or tensors;
results are tensors on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import torch

from .config import as_tensor, resolve_device, result_dtype
from .geometry.camera import (
    camera_matrix,
    intrinsics,
    look_at,
    project_points,
    project_points_orthographic,
)
from .ops.rotations import unit_vec  # noqa: F401 (the reference's users take it from here)


class Camera:
    """Pinhole camera with rotation R (3, 3), position t (3,) and
    intrinsics K (3, 3) (the identity by default)."""

    def __init__(self, R, t, K=None, device=None):
        dev = resolve_device(device)
        dt = result_dtype(R, t, K)
        self._R = as_tensor(R, dev, dt)
        self._t = as_tensor(t, dev, dt)
        self._K = torch.eye(3, dtype=dt, device=dev) if K is None else as_tensor(K, dev, dt)

    def get_camera_matrix(self) -> torch.Tensor:
        """P = K [R^T | -R^T t] (3, 4)."""
        return camera_matrix(self._K, self._R, self._t)

    def get_parameters(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self._K, self._R, self._t

    def project_points(self, X, method: str = "perspective") -> torch.Tensor:
        """(P, 3) -> (P, 2), ``"perspective"`` or ``"orthographic"``."""
        X = as_tensor(X, self._R.device, self._R.dtype)
        if method == "perspective":
            return project_points(X, self._K[None], self._R[None], self._t[None])[0]
        if method == "orthographic":
            return project_points_orthographic(X, self._R[None], self._t[None])[0]
        raise ValueError(f"unknown projection method: {method}")

    @staticmethod
    def create(origin=(0.0, 0.0, 0.0), target=(0.0, 0.0, 1.0), f: float = 1.0,
               f0: float = 1.0, device=None) -> "Camera":
        """Look-at camera at ``origin`` facing ``target``, world-top = +X,
        K = diag(f, f, f0), in float64."""
        dev = resolve_device(device)
        dt = torch.float64
        R, t = look_at(as_tensor(origin, dev, dt), as_tensor(target, dev, dt))
        K = intrinsics(torch.tensor(f, dtype=dt, device=dev), f0)
        return Camera(R, t, K, device=dev)


def calc_projected_points(X, K, R, t, device=None) -> list[torch.Tensor]:
    """Project X (P, 3) through every camera -> a list of (P, 2)."""
    dev = resolve_device(device)
    dt = result_dtype(X, K, R, t)
    x = project_points(*(as_tensor(a, dev, dt) for a in (X, K, R, t)))
    return list(x.unbind(0))


def get_camera_parames(camera_list) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack (K, R, t) of a list of ``Camera``s."""
    K, R, t = zip(*(c.get_parameters() for c in camera_list))
    return torch.stack(K), torch.stack(R), torch.stack(t)
