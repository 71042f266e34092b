"""Synthetic scenes drawn from an explicit ``torch.Generator``.

Counterpart of ``mvrecon_tpu/geometry/scenes.py``: hemisphere cameras at
radius 5 looking at N(0, 0.5) jittered targets, the curved-tube point
cloud, sigma = 0.005 image noise. The scene lives on the generator's
device. Its random numbers differ from the JAX package's for the same
seed, so parity tests build their inputs once with numpy instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .camera import intrinsics, look_at, project_points


def curved_tube_points(n_slices: int = 10, n_angles: int = 20, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """``n_slices`` x-slices in [-1, 1] x ``n_angles`` angles in
    [pi/2, 3pi/2], radius 1/(x+2) -> (n_slices * n_angles, 3)."""
    x = torch.linspace(-1.0, 1.0, n_slices, dtype=dtype, device=device)
    theta = torch.linspace(math.pi / 2, 3 * math.pi / 2, n_angles, dtype=dtype, device=device)
    r = 1.0 / (x + 2.0)
    xx = x.repeat_interleave(n_angles)
    rr = r.repeat_interleave(n_angles)
    tt = theta.repeat(n_slices)
    return torch.stack([xx, rr * torch.cos(tt), rr * torch.sin(tt)], dim=-1)


def sample_hemisphere_points(generator: torch.Generator, num: int, r: float,
                             dtype=torch.float32) -> torch.Tensor:
    """``num`` random positions on the radius-``r`` hemisphere with x >= 0."""
    dev = generator.device
    theta = torch.rand(num, generator=generator, dtype=dtype, device=dev) * (math.pi / 2)
    phi = torch.rand(num, generator=generator, dtype=dtype, device=dev) * (2 * math.pi)
    return torch.stack(
        [r * torch.cos(theta), r * torch.sin(theta) * torch.cos(phi),
         r * torch.sin(theta) * torch.sin(phi)],
        dim=-1,
    )


def add_noise(generator: torch.Generator, x: torch.Tensor, scale: float) -> torch.Tensor:
    """x + N(0, scale^2) noise drawn from ``generator`` (on x's device)."""
    return x + scale * torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


class SyntheticScene(NamedTuple):
    """Ground truth and noisy observations of one synthetic scene."""

    X: torch.Tensor  # (P, 3)
    K: torch.Tensor  # (F, 3, 3)
    R: torch.Tensor  # (F, 3, 3)
    t: torch.Tensor  # (F, 3)
    x: torch.Tensor  # (F, P, 2) noisy projections


def make_synthetic_scene(
    generator: torch.Generator,
    n_images: int = 10,
    f: float = 1.0,
    f0: float = 1.0,
    radius: float = 5.0,
    target_scale: float = 0.5,
    noise: float = 0.005,
    n_slices: int = 10,
    n_angles: int = 20,
    dtype=torch.float32,
) -> SyntheticScene:
    """The reference demo scene, drawn on ``generator``'s device."""
    dev = generator.device
    pos = sample_hemisphere_points(generator, n_images, radius, dtype=dtype)
    targets = target_scale * torch.randn(n_images, 3, generator=generator, dtype=dtype, device=dev)
    R, t = look_at(pos, targets)
    K = intrinsics(torch.full((n_images,), f, dtype=dtype, device=dev), f0)
    X = curved_tube_points(n_slices, n_angles, dtype=dtype, device=dev)
    x_clean = project_points(X, K, R, t)
    x = x_clean + noise * torch.randn(x_clean.shape, generator=generator, dtype=dtype, device=dev)
    return SyntheticScene(X=X, K=K, R=R, t=t, x=x)
