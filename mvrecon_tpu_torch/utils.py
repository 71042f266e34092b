"""Reference-named ``utils`` module (counterpart of ``mvrecon_tpu/utils.py``).

The samplers keep the reference's signatures and draw from NumPy's global
random state, as the reference and the JAX package's shim do, so a seeded
script draws the same numbers; the explicit-generator versions are in
``geometry/scenes.py``. Results are tensors on the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import as_numpy, as_tensor, resolve_device, result_dtype
from .geometry.scenes import curved_tube_points
from .ops.rotations import rodrigues
from .ops.rotations import unit_vec as _unit_vec


def unit_vec(x, device=None) -> torch.Tensor:
    """x / ||x|| along the last axis."""
    return _unit_vec(as_tensor(x, resolve_device(device), result_dtype(x)))


def get_rotation_matrix(omega, device=None) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3, 3)."""
    return rodrigues(as_tensor(omega, resolve_device(device), result_dtype(omega)))


def sample_normal_dist(scale: float, n: int, device=None) -> torch.Tensor:
    """(n, 3) draws of N(0, scale^2) from NumPy's global random state."""
    return as_tensor(np.random.normal(0, scale, (n, 3)), resolve_device(device), torch.float64)


def add_noise(X, scale: float, device=None) -> torch.Tensor:
    """X + N(0, scale^2) noise from NumPy's global random state."""
    X = as_numpy(X)
    out = X + np.random.normal(0, scale, X.shape)
    return as_tensor(out, resolve_device(device), result_dtype(out))


def sample_hemisphere_points(num: int, r: float, device=None) -> torch.Tensor:
    """``num`` points on the radius-``r`` hemisphere with x >= 0, theta ~
    U(0, pi/2) and phi ~ U(0, 2 pi) drawn one point at a time from NumPy's
    global random state (the reference's order of draws)."""
    points = []
    for _ in range(num):
        theta = np.random.uniform(0, np.pi / 2)
        phi = np.random.uniform(0, 2 * np.pi)
        points.append((r * np.cos(theta), r * np.sin(theta) * np.cos(phi),
                       r * np.sin(theta) * np.sin(phi)))
    return as_tensor(np.array(points), resolve_device(device), torch.float64)


def set_points(device=None) -> torch.Tensor:
    """The reference's 200-point curved tube, in float64."""
    return curved_tube_points(dtype=torch.float64, device=resolve_device(device))
