"""Tomasi–Kanade-style rank-r factorization of the observation matrix.

Counterpart of ``mvrecon_tpu/ops/factorization.py``.
"""

from __future__ import annotations

import torch

from .linalg import svd


def factorization_method(w: torch.Tensor, n_rank: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor W (..., M, P) into motion (..., M, n_rank) and shape
    (..., n_rank, P) with the leading factors of the reduced SVD
    (``ops.linalg.svd``: a non-finite W gives NaN factors)."""
    u, s, vt = svd(w)
    return u[..., :, :n_rank], s[..., :n_rank, None] * vt[..., :n_rank, :]
