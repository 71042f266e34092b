"""Similarity alignment (Umeyama) and the aligned-RMSE accuracy metric.

Counterpart of ``mvrecon_tpu/ops/procrustes.py``. Self-calibrated
reconstructions are defined up to a similarity transform (rotation,
translation, scale, possibly a reflection), so comparing one with ground
truth, or two reconstructions whose signs differ, aligns them first: the
closed-form least-squares alignment from one 3x3 SVD (``ops.linalg.svd``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg import svd


class Similarity(NamedTuple):
    scale: torch.Tensor  # ()
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)


def umeyama(source: torch.Tensor, target: torch.Tensor,
            allow_reflection: bool = False) -> Similarity:
    """Least-squares similarity transform aligning source (P, 3) onto
    target (P, 3): argmin_{s, R, t} ||s R x + t - y||^2 (Umeyama 1991).
    Without ``allow_reflection`` R is a rotation (det +1)."""
    mu_s = source.mean(dim=0)
    mu_t = target.mean(dim=0)
    xs = source - mu_s
    yt = target - mu_t

    cov = torch.einsum("pi,pj->ij", yt, xs) / source.shape[0]
    u, d, vt = svd(cov)

    s_diag = torch.ones(3, dtype=source.dtype, device=source.device)
    if not allow_reflection:
        det_sign = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
        # det_sign == 0 (a degenerate cloud) keeps +1, as in the JAX package
        s_diag[2] = torch.where(det_sign == 0, 1.0, det_sign)

    var_s = torch.mean(torch.sum(xs * xs, dim=1))
    scale = torch.sum(d * s_diag) / var_s
    R = (u * s_diag[None, :]) @ vt
    t = mu_t - scale * R @ mu_s
    return Similarity(scale=scale, R=R, t=t)


def apply_similarity(sim: Similarity, x: torch.Tensor) -> torch.Tensor:
    """s R x + t for points x (P, 3)."""
    return sim.scale * torch.einsum("ij,pj->pi", sim.R, x) + sim.t


def aligned_rmse(source: torch.Tensor, target: torch.Tensor,
                 allow_reflection: bool = True) -> torch.Tensor:
    """RMSE between point clouds after the optimal similarity alignment.
    Reflections are allowed by default, because affine and projective
    self-calibration recover shape only up to an orientation flip."""
    sim = umeyama(source, target, allow_reflection=allow_reflection)
    diff = apply_similarity(sim, source) - target
    return torch.sqrt(torch.mean(torch.sum(diff * diff, dim=1)))
