"""Bundle-adjustment state, gauge and camera model shared by the cores.

Counterpart of the subset of ``mvrecon_tpu/models/bundle_adjustment.py``
that the chunked core needs: the state and result tuples, the 7-DoF gauge
(camera-0 pose plus one baseline component, kept as a mask over the full
9F parameter vector), the projective-scale K normalization
(``intrinsics_from_K``, docs/PARITY.md #6), the homogeneous projection
(p, q, r), the camera-parameter derivatives and the parameter update.
The dense LM core is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.rotations import rodrigues


class BAState(NamedTuple):
    """Optimizable parameters (normalized gauge frame)."""

    X: torch.Tensor  # (P, 3)
    f: torch.Tensor  # (F,)
    u: torch.Tensor  # (F, 2)
    t: torch.Tensor  # (F, 3)
    R: torch.Tensor  # (F, 3, 3)


class BAResult(NamedTuple):
    X: torch.Tensor  # (P, 3) in the original (global) frame
    K: torch.Tensor  # (F, 3, 3)
    R: torch.Tensor  # (F, 3, 3)
    t: torch.Tensor  # (F, 3)
    error: torch.Tensor  # final reprojection error E (sum of squares)
    n_iter: int
    log: dict | None
    distortion: torch.Tensor | None = None


AXIS_MODES = ("x-right_z-forward", "x-up_z-forward")


def _axis_index(axis: str) -> int:
    """0 for x-right (baseline component t1_x), 1 for x-up (t1_y)."""
    if axis not in AXIS_MODES:
        raise ValueError(f"unknown axis mode: {axis}")
    return AXIS_MODES.index(axis)


def gauge_mask(n_images: int, axis: str, dtype, device=None) -> torch.Tensor:
    """(9F,) mask: 0 at the 7 gauge-fixed camera parameters (camera-0 t
    and omega, one component of t1), 1 elsewhere."""
    ax = _axis_index(axis)
    mask = torch.ones(9 * n_images, dtype=dtype, device=device)
    mask[[3, 4, 5, 6, 7, 8, 12 + ax]] = 0
    return mask


def normalize_gauge(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor, axis: str):
    """Move the scene to camera 0 with a unit baseline component. The sign
    is taken in the camera-0 frame (the JAX package's documented deviation,
    docs/PARITY.md #5), so restore(normalize(state)) is the identity.
    Returns the normalized (X, R, t) and the restore info."""
    ax = _axis_index(axis)
    c0c1_len = torch.abs(torch.dot(R[0, :, ax], t[1] - t[0]))
    X_ = X - t[0]
    t_ = t - t[0]
    s = torch.abs(torch.dot(R[0, :, ax], t_[1]))
    X_ = (X_ @ R[0]) / s
    R_ = torch.einsum("ji,fjk->fik", R[0], R)
    t_ = (t_ @ R[0]) / s
    return X_, R_, t_, {"R0": R[0], "t0": t[0], "scale": c0c1_len}


def restore_gauge(info: dict, X: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Invert ``normalize_gauge``."""
    r0, t0, scale = info["R0"], info["t0"], info["scale"]
    return (
        (scale * X) @ r0.T + t0,
        torch.einsum("ij,fjk->fik", r0, R),
        (scale * t) @ r0.T + t0,
    )


def build_K(f: torch.Tensor, u: torch.Tensor, f0: float) -> torch.Tensor:
    """(F, 3, 3) intrinsics from f, (u0, v0), f0."""
    k = torch.zeros((f.shape[0], 3, 3), dtype=f.dtype, device=f.device)
    k[:, 0, 0] = f
    k[:, 1, 1] = f
    k[:, :2, 2] = u
    k[:, 2, 2] = f0
    return k


def intrinsics_from_K(K: torch.Tensor, f0: float):
    """(f, u) of ``K = [[f, 0, u0], [0, f, v0], [0, 0, f0]]`` from a
    projective-scale K: rescale to ``K[2, 2] == f0`` first (self-
    calibration returns K only up to a per-camera scale)."""
    s = f0 / K[:, 2, 2]
    return K[:, 0, 0] * s, K[:, :2, 2] * s[:, None]


def calc_pqr(X: torch.Tensor, K: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Camera matrices P (F, 3, 4) and homogeneous image coordinates
    (p, q, r), each (P, F)."""
    rt = R.transpose(-1, -2)
    trans = -torch.einsum("fij,fj->fi", rt, t)
    pmat = K @ torch.cat([rt, trans[..., None]], dim=-1)
    pqr = torch.einsum("fca,pa->pfc", pmat[:, :, :3], X) + pmat[None, :, :, 3]
    return pmat, pqr[..., 0], pqr[..., 1], pqr[..., 2]


def _camera_param_derivs(state: BAState, p: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                         f0: float):
    """(dp, dq, dr)/d(f, u0, v0, t, omega): (P, F, 9) each, for the points
    ``state.X`` (P, 3)."""
    f, u, t, R, X = state.f, state.u, state.t, state.R, state.X
    shape = p.shape

    # d/df
    dpdf = (p - (u[:, 0] / f0)[None] * r) / f[None]
    dqdf = (q - (u[:, 1] / f0)[None] * r) / f[None]
    zeros = torch.zeros_like(dpdf)
    # d/du
    r_over_f0 = r / f0
    # d/dt: per-image constants, broadcast
    dpdt_f = -(f[:, None] * R[:, :, 0] + u[:, :1] * R[:, :, 2])  # (F, 3)
    dqdt_f = -(f[:, None] * R[:, :, 1] + u[:, 1:2] * R[:, :, 2])
    drdt_f = -f0 * R[:, :, 2]
    # d/domega = cross(-d/dt, X - t)
    x_minus_t = X[:, None, :] - t[None, :, :]  # (P, F, 3)

    def stack(df, du0, du1, dt_f):
        out = torch.empty(shape + (9,), dtype=p.dtype, device=p.device)
        out[..., 0] = df
        out[..., 1] = du0
        out[..., 2] = du1
        out[..., 3:6] = dt_f[None]
        out[..., 6:9] = torch.linalg.cross(-dt_f[None], x_minus_t)
        return out

    return (stack(dpdf, r_over_f0, zeros, dpdt_f), stack(dqdf, zeros, r_over_f0, dqdt_f),
            stack(zeros, zeros, zeros, drdt_f))


def _apply_update(state: BAState, delta_xi: torch.Tensor, delta_x: torch.Tensor) -> BAState:
    """Parameter update; rotations through the axis-angle exponential."""
    d = delta_xi.reshape(state.f.shape[0], 9)
    return BAState(
        X=state.X + delta_x,
        f=state.f + d[:, 0],
        u=state.u + d[:, 1:3],
        t=state.t + d[:, 3:6],
        R=rodrigues(d[:, 6:9]) @ state.R,
    )


def _distorted_residual(state: BAState, p, q, r, x, f0: float, dist=None):
    """(res_p, res_q) from sanitized (p, q, r). Only the undistorted model
    is ported so far."""
    if dist is not None:
        raise NotImplementedError("distortion models are not ported yet")
    return p / r - x[..., 0] / f0, q / r - x[..., 1] / f0
