"""SO(3) primitives: Taylor-safe Rodrigues exponential map.

Counterpart of ``mvrecon_tpu/ops/rotations.py``.
"""

from __future__ import annotations

import torch


def unit_vec(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """x / ||x|| along ``dim``."""
    n = torch.linalg.norm(x, dim=dim, keepdim=True)
    if eps:
        n = n.clamp_min(eps)
    return x / n


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x for (..., 3) input."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation exp([omega]_x), with the
    series coefficients ``sin(t)/t`` and ``(1-cos(t))/t^2`` below
    ``t^2 < 1e-16`` so that omega -> 0 gives the identity."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < 1e-16
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    k = _hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def rodrigues_batched(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotations (:func:`rodrigues`
    takes any leading dimensions)."""
    return rodrigues(omega)
