"""Fourth-moment quadratic forms and the symmetric packings of the metric
upgrade's constraint tensors.

Counterpart of ``mvrecon_tpu/ops/moments.py``: the constraint matrix is
``sum_f V[f]^T C[f] V[f]`` in the flattened n^2 space, one einsum, and
``sym_reduce`` / ``sym_expand`` pack the symmetric 4-tensor into the
reduced (6x6 / 10x10) eigenproblem with the sqrt(2) weights.
"""

from __future__ import annotations

import math

import torch


def fourth_moment_matrix(v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum_f V[f]^T C[f] V[f] for V (..., F, B, D), C (..., F, B, B) -> (..., D, D)."""
    return torch.einsum("...fab,...fai,...fbj->...ij", c, v, v)


def _pairs(n: int) -> list[tuple[int, int]]:
    """Off-diagonal pair order of the packings: n=3 cyclic
    [(1,2), (2,0), (0,1)], n=4 upper-triangle lexicographic."""
    if n == 3:
        return [(1, 2), (2, 0), (0, 1)]
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def sym_reduce(bcal_flat: torch.Tensor, n: int) -> torch.Tensor:
    """Flattened (..., n^2, n^2) fourth-moment matrix -> the reduced
    symmetric matrix of side n + |pairs| (1 on diag-diag, sqrt(2) on
    diag-pair, 2 on pair-pair)."""
    pairs = _pairs(n)
    idx = [a * n + a for a in range(n)] + [i * n + j for i, j in pairs]
    wgt = [1.0] * n + [math.sqrt(2.0)] * len(pairs)
    ix = torch.tensor(idx, device=bcal_flat.device)
    w = torch.tensor(wgt, dtype=bcal_flat.dtype, device=bcal_flat.device)
    return bcal_flat[..., ix, :][..., :, ix] * w[:, None] * w[None, :]


def sym_expand(tau: torch.Tensor, n: int) -> torch.Tensor:
    """Reduced symmetric vectors (..., n + |pairs|) -> symmetric (..., n, n)
    matrices with the off-diagonals divided by sqrt(2)."""
    pairs = _pairs(n)
    out = torch.diag_embed(tau[..., :n])
    rows = torch.tensor([i for i, _ in pairs], device=tau.device)
    cols = torch.tensor([j for _, j in pairs], device=tau.device)
    off = tau[..., n:] * (1.0 / math.sqrt(2.0))
    out[..., rows, cols] = off
    out[..., cols, rows] = off
    return out
