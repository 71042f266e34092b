"""Multi-view DLT triangulation with known cameras.

Counterpart of ``mvrecon_tpu/ops/triangulation.py::triangulate``: per
point, the homogeneous DLT solved through the smallest eigenvector of its
4x4 Gram matrix, batched over all points. With a visibility mask, unseen
rows are zeroed, so ragged tracks triangulate without ragged shapes. The
observation-list variant (``triangulate_sparse``) waits for the sparse
slice.
"""

from __future__ import annotations

import torch

from ..config import as_tensor, result_dtype
from ..geometry.camera import camera_matrix
from .linalg import min_eigvec_sym


def triangulate(x, K, R, t, visibility=None, f0: float = 1.0) -> torch.Tensor:
    """DLT-triangulate observations x (F, P, 2) through cameras (K, R, t)
    -> points (P, 3). The rows of a point's design matrix are
    (x/f0 P3 - P1) and (y/f0 P3 - P2) per camera; the point is the least-
    squares null vector, from the Gram matrix's smallest eigenvector.
    visibility is (P, F). Each input may be a tensor or a numpy array; all
    are taken in x's dtype (float32 when x is not floating) on x's device
    (the CPU for a numpy x)."""
    dev = x.device if torch.is_tensor(x) else torch.device("cpu")
    dt = result_dtype(x)
    x, K, R, t = (as_tensor(a, dev, dt) for a in (x, K, R, t))
    pmat = camera_matrix(K, R, t)  # (F, 3, 4)
    p1, p2, p3 = pmat[:, 0], pmat[:, 1], pmat[:, 2]  # (F, 4)
    row_u = (x[..., 0] / f0)[..., None] * p3[:, None, :] - p1[:, None, :]  # (F, P, 4)
    row_v = (x[..., 1] / f0)[..., None] * p3[:, None, :] - p2[:, None, :]
    if visibility is not None:
        vis = as_tensor(visibility, dev, dt).T[..., None]  # (F, P, 1)
        row_u = row_u * vis
        row_v = row_v * vis
    gram = torch.einsum("fpi,fpj->pij", row_u, row_u) + torch.einsum("fpi,fpj->pij", row_v, row_v)
    xh = min_eigvec_sym(gram)[1]  # (P, 4)
    # normalize the homogeneous coordinate; the sign cancels, |w| is guarded
    w = xh[..., 3:]
    w = torch.where(torch.abs(w) < 1e-12, torch.where(w < 0, -1e-12, 1e-12).to(w.dtype), w)
    return xh[..., :3] / w
