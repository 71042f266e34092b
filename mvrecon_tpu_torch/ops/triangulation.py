"""Multi-view DLT triangulation with known cameras.

Counterpart of ``mvrecon_tpu/ops/triangulation.py::triangulate``: per
point, the homogeneous DLT solved through the smallest eigenvector of its
4x4 Gram matrix, batched over all points. With a visibility mask, unseen
rows are zeroed, so ragged tracks triangulate without ragged shapes.
``triangulate_sparse`` does the same over a flat observation list sorted by
point id (the sparse BA core's layout): per-observation design rows by one
gather of the camera matrices, per-point 4x4 Gram matrices by a sorted
segment sum, O(n_obs) memory.
"""

from __future__ import annotations

import torch

from ..config import as_tensor, resolve_device, result_dtype
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


def triangulate_sparse(point_idx, cam_idx, xy, n_points: int, K, R, t, weights=None,
                       f0: float = 1.0, device=None) -> torch.Tensor:
    """Observation-list DLT triangulation -> points (n_points, 3).

    The DLT of :func:`triangulate` over ``point_idx (N,)``, ``cam_idx
    (N,)``, ``xy (N, 2)`` sorted by point id: per-observation design rows,
    per-point 4x4 Gram matrices by a sorted segment sum (each point's rows
    summed in order), the smallest eigenvector per point through
    ``ops.linalg.eigh`` (slices of 16,384, a non-finite matrix isolated).
    Optional per-observation ``weights`` scale each observation's Gram
    contribution (0 = padding). A point with no (weighted) observation
    comes back at the origin. Runs on the card unless ``device`` says
    otherwise, in xy's dtype."""
    dev = resolve_device(device)
    dt = result_dtype(xy)
    xy, K, R, t = (as_tensor(a, dev, dt) for a in (xy, K, R, t))
    pi = as_tensor(point_idx, dev, torch.int64).contiguous()
    ci = as_tensor(cam_idx, dev, torch.int64)
    nf = K.shape[0]
    pg = camera_matrix(K, R, t).reshape(nf, 12).T.contiguous().index_select(1, ci).view(3, 4, -1)
    row_u = (xy[:, 0] / f0) * pg[2] - pg[0]  # (4, N)
    row_v = (xy[:, 1] / f0) * pg[2] - pg[1]
    contrib = (row_u[:, None] * row_u[None] + row_v[:, None] * row_v[None]).reshape(16, -1)
    if weights is not None:
        contrib = contrib * as_tensor(weights, dev, dt)
    off = torch.searchsorted(pi, torch.arange(n_points + 1, dtype=pi.dtype, device=dev))
    gram = torch.segment_reduce(contrib, "sum", offsets=off.expand(16, n_points + 1), axis=1)
    gram = gram.T.reshape(n_points, 4, 4)
    # an unseen point gets the identity, so eigh stays well-posed; its
    # arbitrary eigenvector is replaced by the origin below
    seen = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) > 0
    gram = torch.where(seen[:, None, None], gram, torch.eye(4, dtype=dt, device=dev))
    xh = min_eigvec_sym(gram)[1]
    w = xh[..., 3:]
    w = torch.where(torch.abs(w) < 1e-12, torch.where(w < 0, -1e-12, 1e-12).to(w.dtype), w)
    return torch.where(seen[:, None], xh[..., :3] / w, 0.0)
