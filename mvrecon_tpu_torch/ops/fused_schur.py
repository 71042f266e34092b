"""Fused Schur-system build: type-major Y assembly and the accumulating
lower-tile SYRK (kernel K2, hand-written for Hopper).

Counterpart of ``mvrecon_tpu/ops/pallas_schur.py``. Per point chunk one
generation pass yields the gradient-side sums (d_F, matG, the float32 rhs
b_p) and the damped coupling factor Y = L^-1 F in parameter-type-major
layout: column j * Fp + f holds camera f's parameter j, row x * C + p holds
point p's component x, Fp = F rounded up to 512. ``syrk_acc`` adds YᵀY
into the lower 512-tiles of a running (9 Fp, 9 Fp) accumulator in place;
``finish_schur`` mirrors the lower tiles once after all chunks.

Precision follows the JAX package: with float32 inputs Y is cast to bf16
(one tensor-core pass, float32 accumulation) while the damped factors and
the rhs stay full float32 — lowering those was measured there to cost LM
retries. With float64 inputs Y and the accumulator stay float64, and the
build is the non-fused algebra, permuted.

Under a robust loss (``huber_delta`` set) both passes take the IRLS weights
of ``robust_kind`` from the residuals at the current cameras and multiply
them into the visibility before any sum: the weighted Y goes through K2 at
the same shapes, and the back-substitution takes the trial error under
those current-state weights.

The BAL radial distortion model (``dist`` (F, 2)) chains the residuals and
the factor planes through its 2x2 Jacobian before anything is summed, as
``pallas_schur._factor_planes`` does there; Y keeps its shape. The OPENCV
model takes the non-fused build (``bundle_adjustment_chunked``).

On a CUDA tensor ``syrk_acc`` launches the kernel in
``csrc/syrk_acc.cu`` or raises; on a CPU tensor it runs the plain version
``syrk_acc_reference``.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.bundle_adjustment import (
    _distorted_residual,
    _distortion_terms,
    build_K,
    calc_pqr,
    robust_weight,
)
from .linalg import chol3x3, inv_lower3
from .syrk import TILE, mirror_lower

# launches of each kernel of this module since the last reset
launch_counts = {"syrk_acc": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def schur_acc_dim(nf: int) -> tuple[int, int]:
    """(f_pad, n_acc): per-type padded camera count and accumulator side."""
    f_pad = _round_up(nf, TILE)
    return f_pad, 9 * f_pad


def syrk_acc_reference(acc: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: acc += YᵀY on the lower tiles, in place, one
    512-row band at a time. The products are summed in float64 and
    rounded once to acc's dtype (a float32 CPU GEMM over a few hundred
    rows is off by more than 1e-6 of the largest entry)."""
    y = y.to(torch.float64)
    for i in range(0, acc.shape[0], TILE):
        acc[i:i + TILE, :i + TILE] += (y[:, i:i + TILE].T @ y[:, :i + TILE]).to(acc.dtype)
    return acc


def _syrk_acc_lib():
    from ._cuda_build import load

    lib = load("syrk_acc")
    fn = lib.syrk_acc_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def syrk_acc(acc: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """acc += YᵀY on the lower 512-tiles, in place; the strictly upper
    tiles are left untouched. acc (n, n), Y (k, n), n a multiple of 512.

    On the card acc must be float32 and Y bf16, both contiguous; the
    kernel is launched on the current stream. On the CPU the plain version
    runs in acc's dtype."""
    n = acc.shape[0]
    if acc.shape != (n, n) or y.dim() != 2 or y.shape[1] != n or n % TILE:
        raise ValueError(f"need acc (n, n) and Y (k, n), n % {TILE} == 0; got "
                         f"{tuple(acc.shape)} and {tuple(y.shape)}")
    if acc.device.type == "cpu" and y.device.type == "cpu":
        return syrk_acc_reference(acc, y)
    if acc.device != y.device or acc.device.type != "cuda":
        raise ValueError(f"acc on {acc.device} and Y on {y.device}")
    if acc.dtype != torch.float32 or y.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes float32 acc and bf16 Y, got {acc.dtype}, {y.dtype}")
    if not (acc.is_contiguous() and y.is_contiguous()) or y.data_ptr() % 16 or acc.data_ptr() % 32:
        raise ValueError("acc and Y must be contiguous and aligned")
    fn = _syrk_acc_lib()
    err = fn(acc.data_ptr(), y.data_ptr(), y.shape[0], n,
             torch.cuda.current_stream(acc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"syrk_acc kernel launch failed: cudaError {err}")
    launch_counts["syrk_acc"] += 1
    return acc


def finish_schur(acc: torch.Tensor) -> torch.Tensor:
    """Mirror the accumulated lower tiles into the full symmetric
    (9 Fp, 9 Fp) type-major sum Fᵀ E⁻¹ F."""
    return mirror_lower(acc, acc.shape[0])


def type_major_free(free: torch.Tensor, nf: int, f_pad: int) -> torch.Tensor:
    """Camera-major (9F,) gauge mask -> padded type-major (9 Fp,); the
    padding entries are 0 (identity rows in the system)."""
    return camera_major_to_type_major(free, nf, f_pad)


def type_major_to_camera_major(v: torch.Tensor, nf: int, f_pad: int) -> torch.Tensor:
    """(9 Fp,) type-major vector -> (9F,) camera-major."""
    return v.reshape(9, f_pad)[:, :nf].T.reshape(-1)


def camera_major_to_type_major(v: torch.Tensor, nf: int, f_pad: int) -> torch.Tensor:
    """(9F,) camera-major vector -> padded (9 Fp,) type-major."""
    return torch.nn.functional.pad(v.reshape(nf, 9).T, (0, f_pad - nf)).reshape(-1)


def assemble_type_major(schur_tm, b_p_tm, matG, d_F, free, c, nf: int, f_pad: int):
    """Damped, gauge-projected reduced camera system in type-major layout.

    Returns (A', b', free_tm): A' = blockdiag(Gc) - schur with identity
    rows on fixed and padding parameters."""
    eye9 = torch.eye(9, dtype=matG.dtype, device=matG.device)
    gc = matG + c * matG * eye9[None]  # (F, 9, 9)
    a = (-schur_tm).reshape(9, f_pad, 9, f_pad)
    idx = torch.arange(nf, device=a.device)
    a[:, idx, :, idx] += gc  # A'[(i, f), (j, f)] += Gc[f, i, j]
    m = 9 * f_pad
    a = a.reshape(m, m)
    free_tm = type_major_free(free, nf, f_pad)
    a = a * (free_tm[:, None] * free_tm[None, :]) + torch.diag(1.0 - free_tm)
    b = (b_p_tm - camera_major_to_type_major(d_F, nf, f_pad)) * free_tm
    return a, b, free_tm


def _factor_planes(cam, X_c, x_c, pmat, p, q, r, f0: float, dist=None):
    """Raw residuals, a-factors (C, F, 3) and type-major b planes (9, C, F)
    [parameter order f, u, v, t(3), omega(3)]. With ``dist`` (the BAL radial
    model, (F, 2)) they chain through the distortion as the camera-major
    ``_apply_distortion_chain`` does, with the u and v fix-ups on planes 1
    and 2 and the f one on plane 0."""
    inv_r2 = 1.0 / (r * r)
    res_p = p / r - x_c[..., 0] / f0
    res_q = q / r - x_c[..., 1] / f0

    a1 = (r[..., None] * pmat[None, :, 0, :3] - p[..., None] * pmat[None, :, 2, :3]) * inv_r2[..., None]
    a2 = (r[..., None] * pmat[None, :, 1, :3] - q[..., None] * pmat[None, :, 2, :3]) * inv_r2[..., None]

    f, u, t, R = cam.f, cam.u, cam.t, cam.R
    dpdt = -(f[:, None] * R[:, :, 0] + u[:, :1] * R[:, :, 2])
    dqdt = -(f[:, None] * R[:, :, 1] + u[:, 1:2] * R[:, :, 2])
    drdt = -f0 * R[:, :, 2]
    xm = X_c[:, None, :] - t[None, :, :]

    def cross_k(dfT, k):
        k1, k2 = (k + 1) % 3, (k + 2) % 3
        return -(dfT[None, :, k1] * xm[..., k2] - dfT[None, :, k2] * xm[..., k1])

    zero = torch.zeros_like(p)
    dp0 = (p - (u[:, 0] / f0)[None] * r) / f[None]
    dq0 = (q - (u[:, 1] / f0)[None] * r) / f[None]
    rf0 = r / f0
    b1 = torch.stack([
        r * dp0 * inv_r2, r * rf0 * inv_r2, zero,
        *[(r * dpdt[None, :, k] - p * drdt[None, :, k]) * inv_r2 for k in range(3)],
        *[(r * cross_k(dpdt, k) - p * cross_k(drdt, k)) * inv_r2 for k in range(3)],
    ])
    b2 = torch.stack([
        r * dq0 * inv_r2, zero, r * rf0 * inv_r2,
        *[(r * dqdt[None, :, k] - q * drdt[None, :, k]) * inv_r2 for k in range(3)],
        *[(r * cross_k(dqdt, k) - q * cross_k(drdt, k)) * inv_r2 for k in range(3)],
    ])
    if dist is not None:
        g1, g2, s, d, wu = _distortion_terms(cam, p, q, r, f0, dist, "radial")
        res_p = res_p + (d - 1.0) * g1
        res_q = res_q + (d - 1.0) * g2
        cw = wu * (f0 / cam.f)[None] ** 2
        d11 = d + cw * g1 * g1
        d12 = cw * g1 * g2
        d22 = d + cw * g2 * g2
        a1, a2 = (d11[..., None] * a1 + d12[..., None] * a2,
                  d12[..., None] * a1 + d22[..., None] * a2)
        inv_f0 = 1.0 / f0
        b1[1] -= inv_f0  # b -> dg/dtheta (u and v planes only)
        b2[2] -= inv_f0
        b1, b2 = d11[None] * b1 + d12[None] * b2, d12[None] * b1 + d22[None] * b2
        b1[1] += inv_f0  # + d(u/f0)/du
        b2[2] += inv_f0
        cf = wu * s / cam.f[None]  # -(wu s / f) g on the f plane
        b1[0] -= cf * g1
        b2[0] -= cf * g2
    return res_p, res_q, a1, a2, b1, b2


def _point_terms(cam, X_c, x_c, vis_c, f0: float, c, huber_delta=None,
                 robust_kind: str = "huber", dist=None):
    """Per-chunk generation shared by the build and the back-substitution:
    the effective visibility (IRLS-weighted with ``huber_delta``, from the
    distorted residuals with ``dist``), the factor planes, the point
    gradient d_P, the point blocks matE and the damped Cholesky inverse
    L⁻¹ of each (1 + c diag) matE."""
    dt = x_c.dtype
    c_pts, nf = x_c.shape[0], x_c.shape[1]
    pmat, p, q, r = calc_pqr(X_c, build_K(cam.f, cam.u, f0), cam.R, cam.t)
    vis_d = vis_c.expand(c_pts, nf).to(dt)
    r = torch.where(vis_d > 0, r, torch.ones_like(r))
    res_p, res_q, a1, a2, b1, b2 = _factor_planes(cam, X_c, x_c, pmat, p, q, r, f0, dist)
    if huber_delta is not None:
        vis_d = vis_d * robust_weight(torch.sqrt(res_p**2 + res_q**2), huber_delta, robust_kind)

    visf = vis_d[..., None]
    d_P = 2.0 * torch.sum(visf * (res_p[..., None] * a1 + res_q[..., None] * a2), dim=1)
    matE = 2.0 * (torch.einsum("pfi,pfj->pij", visf * a1, a1)
                  + torch.einsum("pfi,pfj->pij", visf * a2, a2))
    eye3 = torch.eye(3, dtype=dt, device=x_c.device)
    seen = (torch.sum(vis_d, dim=1) > 0).to(dt)
    matE = matE + (1.0 - seen)[:, None, None] * eye3
    linv = inv_lower3(chol3x3(matE + c * matE * eye3[None]))
    return vis_d, res_p, res_q, a1, a2, b1, b2, d_P, matE, linv


def fused_chunk_update(acc, cam, X_c, x_c, vis_c, f0: float, c, huber_delta=None,
                       robust_kind: str = "huber", dist=None):
    """One chunk of the fused build: the gradient-side quantities, the
    damped type-major Y, and its SYRK accumulated into ``acc`` in place;
    everything IRLS-weighted with ``huber_delta`` and through the radial
    distortion with ``dist``.

    Returns (acc, d_F_cm (9F,) unmasked, matG (F, 9, 9), e_chunk (the
    weighted E with ``huber_delta``), b_p (9, Fp))."""
    dt = x_c.dtype
    c_pts, nf = x_c.shape[0], x_c.shape[1]
    n_acc = acc.shape[0]
    f_pad = n_acc // 9
    vis_d, res_p, res_q, a1, a2, b1, b2, d_P, _, linv = _point_terms(
        cam, X_c, x_c, vis_c, f0, c, huber_delta, robust_kind, dist)
    e_chunk = torch.sum(vis_d * (res_p**2 + res_q**2))

    w2 = 2.0 * vis_d
    yd = torch.einsum("pxy,py->px", linv, d_P)
    al1 = torch.einsum("pxw,pfw->xpf", linv, a1) * w2[None]
    al2 = torch.einsum("pxw,pfw->xpf", linv, a2) * w2[None]

    # d_F (type-major -> camera-major), the rhs b_p and matG from the planes
    d_F_tm = 2.0 * (torch.einsum("pf,jpf->jf", vis_d * res_p, b1)
                    + torch.einsum("pf,jpf->jf", vis_d * res_q, b2))  # (9, F)
    d_F_cm = d_F_tm.T.reshape(9 * nf)
    b_p = (torch.einsum("pf,jpf->jf", torch.einsum("xpf,px->pf", al1, yd), b1)
           + torch.einsum("pf,jpf->jf", torch.einsum("xpf,px->pf", al2, yd), b2))
    matG = 2.0 * (torch.einsum("ipf,jpf->fij", vis_d[None] * b1, b1)
                  + torch.einsum("ipf,jpf->fij", vis_d[None] * b2, b2))

    # damped Y (3, C, 9, F) -> padded type-major (3C, 9 Fp)
    y = al1[:, :, None, :] * b1.transpose(0, 1)[None] + al2[:, :, None, :] * b2.transpose(0, 1)[None]
    y_dt = torch.bfloat16 if dt == torch.float32 else dt
    y_pad = torch.zeros((3, c_pts, 9, f_pad), dtype=y_dt, device=acc.device)
    y_pad[..., :nf] = y
    syrk_acc(acc, y_pad.view(3 * c_pts, n_acc))
    return acc, d_F_cm, matG, e_chunk, torch.nn.functional.pad(b_p, (0, f_pad - nf))


def fused_backsub_chunk(cam, trial_cam, X_c, x_c, vis_c, f0: float, c, delta_xi_cm,
                        huber_delta=None, robust_kind: str = "huber", dist=None):
    """Back-substitution for one chunk from the type-major b planes. With
    ``huber_delta`` the weights are taken anew at the current cameras
    ``cam``, and the trial error at ``trial_cam`` is summed under them;
    with ``dist`` the trial error is the distorted one.

    Returns (X_new, e_trial_chunk, dDd_chunk, g_d_chunk)."""
    nf = x_c.shape[1]
    vis_d, _, _, a1, a2, b1, b2, d_P, matE, linv = _point_terms(
        cam, X_c, x_c, vis_c, f0, c, huber_delta, robust_kind, dist)

    dxi_tm = delta_xi_cm.reshape(nf, 9).T  # (9, F)
    s1 = vis_d * torch.einsum("jpf,jf->pf", b1, dxi_tm)
    s2 = vis_d * torch.einsum("jpf,jf->pf", b2, dxi_tm)
    f_dxi = 2.0 * (torch.einsum("pf,pfx->px", s1, a1) + torch.einsum("pf,pfx->px", s2, a2))
    rhs = f_dxi + d_P
    # E_c^-1 = L^-T L^-1
    delta_x = -torch.einsum("pwx,pw->px", linv, torch.einsum("pwy,py->pw", linv, rhs))
    X_new = X_c + delta_x

    diag_e = torch.diagonal(matE, dim1=-2, dim2=-1)
    dDd_c = torch.sum(delta_x * diag_e * delta_x)
    gd_c = torch.sum(d_P * delta_x)

    K_trial = build_K(trial_cam.f, trial_cam.u, f0)
    _, pt, qt, rt = calc_pqr(X_new, K_trial, trial_cam.R, trial_cam.t)
    rt = torch.where(vis_d > 0, rt, torch.ones_like(rt))
    res_tp, res_tq = _distorted_residual(trial_cam, pt, qt, rt, x_c, f0, dist, "radial")
    e_c = torch.sum(vis_d * (res_tp**2 + res_tq**2))
    return X_new, e_c, dDd_c, gd_c
