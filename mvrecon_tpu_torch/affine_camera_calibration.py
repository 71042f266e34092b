"""Reference-named ``affine_camera_calibration`` module (counterpart of
``mvrecon_tpu/affine_camera_calibration.py``). Each entry point takes the
reference's list of (P, 2) arrays, one per image, or a stacked (F, P, 2)
array, and returns (S (P, 3), R (F, 3, 3)) as tensors on the card unless
``device`` says otherwise. The SVD keeps the backend's signs, as in the
JAX package.
"""

from __future__ import annotations

import torch

from .config import as_tensor, resolve_device, result_dtype
from .models.affine import affine_self_calibration, observation_matrix


def _as_dense(data_list, device) -> torch.Tensor:
    """A list of (P, 2) arrays or one (F, P, 2) array -> (F, P, 2) tensor."""
    dev = resolve_device(device)
    if isinstance(data_list, (list, tuple)):
        if len({len(x) for x in data_list}) != 1:
            raise ValueError("all images must observe the same number of points")
        dt = result_dtype(*data_list)
        return torch.stack([as_tensor(x, dev, dt) for x in data_list])
    return as_tensor(data_list, dev, result_dtype(data_list))


def orthographic_self_calibration(data_list, device=None):
    """Orthographic metric upgrade."""
    x = _as_dense(data_list, device)
    return affine_self_calibration(x, model="orthographic", device=x.device)


def symmetric_affine_self_calibration(data_list, device=None):
    """Symmetric-affine metric upgrade."""
    x = _as_dense(data_list, device)
    return affine_self_calibration(x, model="symmetric", device=x.device)


def paraperspective_self_calibration(data_list, f, device=None):
    """Paraperspective metric upgrade with one focal length per image."""
    x = _as_dense(data_list, device)
    f = as_tensor(f, x.device, x.dtype)
    if x.shape[0] != f.shape[0]:
        raise ValueError("need one focal length per image")
    return affine_self_calibration(x, model="paraperspective", f=f, device=x.device)


def _get_observation_matrix(data_list, device=None):
    """(W (2F, P), t (2F,)): the centred observation matrix."""
    return observation_matrix(_as_dense(data_list, device))
