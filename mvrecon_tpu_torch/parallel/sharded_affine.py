"""Point-sharded affine self-calibration over the ranks of a mesh.

Counterpart of ``mvrecon_tpu/parallel/sharded_affine.py``. The affine
shape step needs no SVD of the centered observation matrix W (2F, P),
only its leading rank-3 left subspace and each point's coefficient row,
so with the P axis split over the mesh's ``points`` axis:

- the per-image centroids t (F, 2) are one all-reduce of the per-image
  sums;
- U3 (2F, 3) comes from an eigh of the (2F, 2F) Gram G = W W^T: each rank
  multiplies its (2F, Pl) block by itself and one all-reduce of 4F^2
  values completes G; its top eigenvectors are W's left singular vectors;
- the metric upgrade (``models.affine.metric_upgrade_from_subspace``) is
  replicated O(F) work on every rank;
- the shape rows stay on the rank: S_l = A^-1 (W_l^T U3)^T, whose
  coefficient rows already carry the singular values.

Signs: flipping a subspace column flips a shape axis and can mirror the
solution, so each column is pinned so that the first point's shape
coordinate is non-negative, the convention of ``affine_self_calibration(
canonical_signs=True)``. The first point is the first column of the
rank at coordinate 0 of the points axis; the others add zeros to its
all-reduce.
"""

from __future__ import annotations

import torch

from ..config import as_tensor
from ..models.affine import _COEFFS, metric_upgrade_from_subspace
from ..models.bundle_adjustment import _psum
from ..ops.linalg import eigh
from ..runtime.distributed import gather_array
from .mesh import bind_axes
from .sharded_calibration import POINTS_AXIS, points_block


def _calibrate_local(x_l: torch.Tensor, f, model: str, n_total: int, first: bool,
                     axis_name: str | None):
    """x_l (F, Pl, 2), this rank's block of the observations -> (S_l (Pl,
    3), R (F, 3, 3), ok); ``first``: this rank holds the first point."""
    nf = x_l.shape[0]
    t = _psum(x_l.sum(dim=1), axis_name) / n_total  # (F, 2)
    centered = x_l - t[:, None, :]
    w_l = centered.transpose(1, 2).reshape(2 * nf, -1)  # (2F, Pl)
    _, evecs = eigh(_psum(w_l @ w_l.T, axis_name))  # ascending
    u3 = evecs[:, -3:].flip(-1)  # top three, descending
    w0 = w_l[:, 0] if first else torch.zeros_like(w_l[:, 0])
    s0 = _psum(w0.clone(), axis_name) @ u3  # the first point's shape coordinates
    u3 = u3 * torch.where(s0 < 0, -1.0, 1.0).to(x_l.dtype)
    A, R = metric_upgrade_from_subspace(u3, t, model, f)
    coeff_l = w_l.T @ u3  # (Pl, 3)
    s_l = torch.linalg.solve_triangular(A, coeff_l.T, upper=False).T
    bad = _psum(torch.sum(~torch.isfinite(s_l)), axis_name)
    ok = (bad == 0) & torch.isfinite(R).all() & torch.isfinite(A).all()
    return s_l, R, ok


def affine_self_calibration_block(mesh, x_l: torch.Tensor, n_points: int,
                                  model: str = "paraperspective", f=None):
    """:func:`sharded_affine_self_calibration` from this rank's block x_l
    (F, Pl, 2) (``sharded_calibration.points_block``) of ``n_points`` in
    all. Returns (S_l (Pl, 3), R, ok): the shape rows are the block's;
    nothing is gathered."""
    if model not in _COEFFS:
        raise ValueError(f"unknown affine model: {model}")
    if model == "paraperspective" and f is None:
        raise ValueError("paraperspective model requires focal lengths f")
    if f is not None:
        f = as_tensor(f, x_l.device, x_l.dtype)
    first = mesh.get_local_rank(POINTS_AXIS) == 0
    with bind_axes(mesh):
        return _calibrate_local(x_l, f, model, n_points, first, POINTS_AXIS)


def sharded_affine_self_calibration(mesh, x, model: str = "paraperspective", f=None,
                                    device=None):
    """Affine self-calibration with the P axis of the observations x
    (F, P, 2) split over the mesh's ``points`` axis. Returns (S, R, ok):
    S (P, 3) and R (F, 3, 3) global on every rank, and ``ok`` (a bool
    tensor, False where the metric matrix was not positive definite or a
    value is not finite: then S and R hold NaN, as in
    ``models.affine.affine_self_calibration_full``).

    P must be divisible by the points-axis size (``ValueError`` before any
    collective): calibration keeps the full-visibility contract, so there
    is no mask to neutralize padding in the Gram. Runs on the card unless
    ``device`` says otherwise; the working dtype is x's."""
    x_l = points_block(mesh, x, device)
    s_l, r, ok = affine_self_calibration_block(mesh, x_l, x.shape[1], model=model, f=f)
    return gather_array(mesh, s_l, (POINTS_AXIS,)), r, ok
