"""Pinhole camera model, batched over cameras.

Counterpart of ``mvrecon_tpu/geometry/camera.py``. A rig is stacked
tensors ``K (F, 3, 3), R (F, 3, 3), t (F, 3)``; the camera matrix is
``P = K [R^T | -R^T t]`` and look-at uses world-top = +X.
"""

from __future__ import annotations

import torch

from ..ops.rotations import unit_vec


def intrinsics(f: torch.Tensor, f0: float = 1.0, u: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 3, 3) K = [[f, 0, u0], [0, f, v0], [0, 0, f0]] (u defaults to 0)."""
    k = torch.zeros(f.shape + (3, 3), dtype=f.dtype, device=f.device)
    k[..., 0, 0] = f
    k[..., 1, 1] = f
    k[..., 2, 2] = f0
    if u is not None:
        k[..., :2, 2] = u
    return k


def camera_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R^T | -R^T t] -> (..., 3, 4)."""
    rt = R.transpose(-1, -2)
    trans = -torch.einsum("...ij,...j->...i", rt, t)
    return K @ torch.cat([rt, trans[..., None]], dim=-1)


def look_at(origin: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, t) from camera positions and look-at targets, world-top = +X."""
    world_top = torch.tensor([1.0, 0.0, 0.0], dtype=origin.dtype, device=origin.device)
    camera_z = unit_vec(target - origin)
    camera_y = unit_vec(torch.linalg.cross(camera_z, world_top.expand_as(camera_z)))
    camera_x = unit_vec(torch.linalg.cross(camera_y, camera_z))
    return torch.stack([camera_x, camera_y, camera_z], dim=-1), origin


def project_points(X: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Project points X (P, 3) through cameras (F, ...) -> (F, P, 2)."""
    P = camera_matrix(K, R, t)  # (F, 3, 4)
    proj = torch.einsum("fij,pj->fpi", P[..., :3], X) + P[:, None, :, 3]
    return proj[..., :2] / proj[..., 2:3]


def project_points_orthographic(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Orthographic projection of points X (..., P, 3) through cameras
    (..., F, ...): the camera-frame x, y without a divide -> (..., F, P, 2)."""
    rt = R.transpose(-1, -2)
    xc = (torch.einsum("...fij,...pj->...fpi", rt, X)
          - torch.einsum("...fij,...fj->...fi", rt, t)[..., None, :])
    return xc[..., :2]
