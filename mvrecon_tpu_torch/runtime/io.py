"""Observation I/O: load/save tracked-feature data for reconstruction.

The port's own copy of ``mvrecon_tpu/runtime/io.py`` (numpy only; the port
imports nothing of the JAX package): npz, BAL (dense and observation-list),
COLMAP text and binary models of eleven camera models, PLY.

The reference only consumes synthetic in-process data; a framework needs a
data path for real tracks. Format: a single ``.npz`` with

- ``x``: (F, P, 2) float — tracked image points per view
- ``visibility``: optional (P, F) bool — which points are seen where
- ``f``: optional (F,) float — focal lengths (affine paraperspective)
- ``f0``: optional scalar — scale constant
- ``X``/``K``/``R``/``t``: optional ground truth / initialization arrays
"""

from __future__ import annotations

from typing import Any

import numpy as np


def save_observations(path: str, x, visibility=None, f=None, f0=None, **extra) -> None:
    data: dict[str, Any] = {"x": np.asarray(x)}
    if visibility is not None:
        data["visibility"] = np.asarray(visibility)
    if f is not None:
        data["f"] = np.asarray(f)
    if f0 is not None:
        data["f0"] = np.asarray(f0)
    for k, v in extra.items():
        data[k] = np.asarray(v)
    np.savez(path, **data)


def load_observations(path: str) -> dict[str, np.ndarray]:
    data = dict(np.load(path, allow_pickle=False))
    if "x" not in data:
        raise ValueError(f"{path} has no 'x' array (expected (F, P, 2) tracks)")
    x = data["x"]
    if x.ndim != 3 or x.shape[-1] != 2:
        raise ValueError(f"'x' must be (F, P, 2), got {x.shape}")
    return data


def load_bal(path: str) -> dict[str, np.ndarray]:
    """Parse a Bundle Adjustment in the Large (BAL) problem file — the
    standard public BA benchmark format (Agarwal et al., "Bundle
    Adjustment in the Large", ECCV 2010): a text file with

        n_cameras n_points n_observations
        <cam_idx pt_idx u v>            x n_observations
        <9 camera params, one per line> x n_cameras
            (Rodrigues rotation, translation, f, k1, k2)
        <3 point coords, one per line>  x n_points

    Returns the framework's dense layout: ``x`` (F, P, 2) with zeros at
    unobserved pairs, ``visibility`` (P, F), and initialization arrays
    ``X`` (P, 3), ``R``/``t``/``K`` (per camera) converted from BAL's
    convention to this framework's:

    - BAL: x_cam = R_bal X + t_bal, pixel = f * d(k1, k2) * (-x_cam.xy /
      x_cam.z) (cameras look down -z). Here: x_cam = R^T (X - t),
      pixel = f * x_cam.xy / (f0 * x_cam.z / f0).
    - Conversion: R = R_bal^T, t = -R_bal^T t_bal, and the observed
      pixels are negated (which absorbs the -z convention exactly; the
      projective depth r is then negative for points in front of a BAL
      camera, which every residual/derivative expression handles —
      only the sign-sensitive cheirality heuristics of the calibration
      stage assume positive depth, and BAL problems come with an
      initialization, so calibration is skipped anyway).
    - The radial distortion (k1, k2) is returned as ``distortion`` (F, 2)
      and is directly consumable by ``bundle_adjust(distortion=...)``
      (``models/bundle_adjustment.py``): the BAL model's s = |rho|^2 is
      sign-invariant and the pixel negation passes through ``d(s) g``
      linearly, so the converted problem optimizes the *exact* BAL
      objective. ``LMConfig.distortion_rounds`` additionally re-estimates
      (k1, k2) by the closed-form per-camera (or ``distortion_shared``)
      refit. Ignoring it (``distortion=None``) reproduces the pinhole
      model, which converges to a distortion-limited error floor.
    """
    nf, npts, cam_idx, pt_idx, uv, cams, pts = _parse_bal_tokens(path)
    x = np.zeros((nf, npts, 2))
    vis = np.zeros((npts, nf))
    x[cam_idx, pt_idx] = -uv  # negation absorbs BAL's -z projection
    vis[pt_idx, cam_idx] = 1.0
    out = _bal_cams_to_framework(cams)
    out.update(x=x, visibility=vis, X=pts, f0=np.asarray(1.0))
    return out


def _parse_bal_tokens(path: str):
    """Shared BAL text parser: header, observation triplets, camera and
    point parameter blocks (format docs in :func:`load_bal`)."""
    with open(path) as fh:
        tokens = fh.read().split()
    nf, npts, nobs = int(tokens[0]), int(tokens[1]), int(tokens[2])
    body = np.asarray(tokens[3:3 + 4 * nobs])
    quad = body.reshape(nobs, 4)
    cam_idx = quad[:, 0].astype(np.int64)
    pt_idx = quad[:, 1].astype(np.int64)
    uv = quad[:, 2:4].astype(np.float64)
    rest = np.asarray(tokens[3 + 4 * nobs:], dtype=np.float64)
    cams = rest[: 9 * nf].reshape(nf, 9)
    pts = rest[9 * nf: 9 * nf + 3 * npts].reshape(npts, 3)
    return nf, npts, cam_idx, pt_idx, uv, cams, pts


def _bal_cams_to_framework(cams: np.ndarray) -> dict[str, np.ndarray]:
    """BAL 9-parameter cameras (Rodrigues w, t_bal, f, k1, k2) -> this
    framework's (R, t, K, f, distortion) (conversion docs in
    :func:`load_bal`)."""
    nf = cams.shape[0]
    w = cams[:, :3]
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    with np.errstate(invalid="ignore"):
        axis = np.where(theta > 0, w / np.where(theta == 0, 1.0, theta), 0.0)
    k_cross = np.zeros((nf, 3, 3))
    k_cross[:, 0, 1] = -axis[:, 2]
    k_cross[:, 0, 2] = axis[:, 1]
    k_cross[:, 1, 0] = axis[:, 2]
    k_cross[:, 1, 2] = -axis[:, 0]
    k_cross[:, 2, 0] = -axis[:, 1]
    k_cross[:, 2, 1] = axis[:, 0]
    st, ct = np.sin(theta)[..., None], np.cos(theta)[..., None]
    r_bal = ct * np.eye(3) + st * k_cross + (1 - ct) * np.einsum(
        "fi,fj->fij", axis, axis
    )
    r = r_bal.transpose(0, 2, 1)
    t = -np.einsum("fji,fj->fi", r_bal, cams[:, 3:6])
    f = cams[:, 6]
    k_mats = np.zeros((nf, 3, 3))
    k_mats[:, 0, 0] = f
    k_mats[:, 1, 1] = f
    k_mats[:, 2, 2] = 1.0
    return {"R": r, "t": t, "K": k_mats, "f": f,
            "distortion": cams[:, 7:9]}


def load_bal_sparse(path: str) -> dict[str, np.ndarray]:
    """Parse a BAL problem straight into the observation-list layout of
    the sparse observation-list BA core — the dense
    (F, P, 2) arrays of :func:`load_bal` are never materialized, so
    BAL-class problems (thousands of cameras, millions of points, <1%
    fill) load in O(n_observations) host memory.

    Returns ``point_idx``/``cam_idx``/``xy`` (point-sorted; the pixel
    negation and camera conversion of :func:`load_bal` applied) plus the
    same ``X``/``R``/``t``/``K``/``f``/``distortion``/``f0`` arrays."""
    nf, npts, cam_idx, pt_idx, uv, cams, pts = _parse_bal_tokens(path)
    order = np.argsort(pt_idx, kind="stable")
    out = _bal_cams_to_framework(cams)
    out.update(
        point_idx=pt_idx[order], cam_idx=cam_idx[order], xy=-uv[order],
        X=pts, f0=np.asarray(1.0),
        n_cameras=np.asarray(nf), n_points=np.asarray(npts),
    )
    return out


def save_bal(path: str, x, visibility, X, R, t, f, distortion=None) -> None:
    """Write a BAL-format problem (inverse of :func:`load_bal`'s
    conventions: pixels negated, R/t converted back to world->camera).
    The BAL camera is 9-parameter (w, t, f, k1, k2), so only the radial
    (F, 2) distortion layout can be written — use :func:`save_colmap`
    for the 4-parameter OPENCV / OPENCV_FISHEYE models."""
    if distortion is not None and np.asarray(distortion).shape[-1] != 2:
        raise ValueError(
            "BAL files carry exactly (k1, k2); got a "
            f"{np.asarray(distortion).shape[-1]}-column distortion — "
            "write a COLMAP model instead (save_colmap)"
        )
    x = np.asarray(x)
    vis = np.asarray(visibility)
    pt_i, cam_i = np.nonzero(vis > 0)
    save_bal_sparse(path, pt_i, cam_i, x[cam_i, pt_i], x.shape[1],
                    X, R, t, f, distortion=distortion)


def save_bal_sparse(path: str, point_idx, cam_idx, xy, n_points,
                    X, R, t, f, distortion=None) -> None:
    """Observation-list variant of :func:`save_bal` (same conventions):
    writes the BAL file straight from (point_idx, cam_idx, xy) triples,
    so O(n_obs)-memory pipelines round-trip without ever building the
    dense arrays."""
    if distortion is not None and np.asarray(distortion).shape[-1] != 2:
        raise ValueError(
            "BAL files carry exactly (k1, k2); got a "
            f"{np.asarray(distortion).shape[-1]}-column distortion - "
            "write a COLMAP model instead (save_colmap)"
        )
    xy = np.asarray(xy)
    pt_i = np.asarray(point_idx)
    cam_i = np.asarray(cam_idx)
    f = np.asarray(f)
    nf, npts = f.shape[0], int(n_points)
    lines = [f"{nf} {npts} {len(pt_i)}"]
    for p, c, uv in zip(pt_i, cam_i, xy):
        lines.append(f"{c} {p} {float(-uv[0])!r} {float(-uv[1])!r}")
    R = np.asarray(R)
    t = np.asarray(t)
    dist = np.zeros((nf, 2)) if distortion is None else np.asarray(distortion)
    for i in range(nf):
        r_bal = R[i].T
        # rotation matrix -> Rodrigues vector
        cos_t = np.clip((np.trace(r_bal) - 1.0) / 2.0, -1.0, 1.0)
        theta = np.arccos(cos_t)
        skew = np.array([
            r_bal[2, 1] - r_bal[1, 2],
            r_bal[0, 2] - r_bal[2, 0],
            r_bal[1, 0] - r_bal[0, 1],
        ])
        if theta < 1e-12:
            w = np.zeros(3)
        elif np.pi - theta < 1e-3:
            # theta ~ pi: skew/(2 sin) is 0/0 — recover the axis from the
            # well-conditioned symmetric part aa^T = (R + R^T)/2 - cos I,
            # scaled by 1/(1 - cos); sign from the residual skew part
            # (at exactly pi, +a and -a encode the same rotation).
            aat = ((r_bal + r_bal.T) / 2.0 - cos_t * np.eye(3)) / (1.0 - cos_t)
            k = int(np.argmax(np.diag(aat)))
            axis = aat[:, k] / np.sqrt(max(aat[k, k], 1e-30))
            axis /= np.linalg.norm(axis)
            if np.dot(skew, axis) < 0:
                axis = -axis
            w = theta * axis
        else:
            w = theta / (2.0 * np.sin(theta)) * skew
        t_bal = -r_bal @ t[i]
        for val in (*w, *t_bal, f[i], *dist[i]):
            lines.append(repr(float(val)))
    for p in np.asarray(X):
        for val in p:
            lines.append(repr(float(val)))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(..., 4) unit quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = (q[..., i] for i in range(4))
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def _rotmat_to_quat(m: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> (w, x, y, z) unit quaternion via the
    largest-component (Shepperd) method — numerically stable at every
    angle (no sin(theta) division, unlike the Rodrigues extraction)."""
    tr = np.trace(m)
    cands = np.array([
        1.0 + tr,
        1.0 + m[0, 0] - m[1, 1] - m[2, 2],
        1.0 - m[0, 0] + m[1, 1] - m[2, 2],
        1.0 - m[0, 0] - m[1, 1] + m[2, 2],
    ])
    k = int(np.argmax(cands))
    s = 2.0 * np.sqrt(max(cands[k], 0.0))
    if k == 0:
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif k == 1:
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif k == 2:
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def _colmap_tokens(path: str):
    """Token lists of a COLMAP text file's non-comment lines."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line.split()


_COLMAP_MODEL_NAMES = {0: "SIMPLE_PINHOLE", 1: "PINHOLE",
                       2: "SIMPLE_RADIAL", 3: "RADIAL", 4: "OPENCV",
                       5: "OPENCV_FISHEYE", 6: "FULL_OPENCV", 7: "FOV",
                       8: "SIMPLE_RADIAL_FISHEYE", 9: "RADIAL_FISHEYE",
                       10: "THIN_PRISM_FISHEYE"}
_COLMAP_NUM_PARAMS = {"SIMPLE_PINHOLE": 3, "PINHOLE": 4,
                      "SIMPLE_RADIAL": 4, "RADIAL": 5, "OPENCV": 8,
                      "OPENCV_FISHEYE": 8, "FULL_OPENCV": 12, "FOV": 5,
                      "SIMPLE_RADIAL_FISHEYE": 4, "RADIAL_FISHEYE": 5,
                      "THIN_PRISM_FISHEYE": 12}
_COLMAP_MODEL_IDS = {v: k for k, v in _COLMAP_MODEL_NAMES.items()}


def _colmap_camera_fk(cam_id: int, model: str, p: list):
    """(f, cx, cy, (d1, d2, d3, d4), kind) from a COLMAP camera's
    (model, params). ``kind`` is the framework distortion family the
    four d-columns belong to: "opencv" ((k1, k2, p1, p2) — the radial
    models zero-fill p) or "fisheye" (OPENCV_FISHEYE's k1..k4
    theta-polynomial)."""

    def _one_focal(fx, fy):
        if abs(fx - fy) > 1e-6 * max(abs(fx), abs(fy)):
            raise ValueError(
                f"camera {cam_id}: fx={fx} != fy={fy}; this framework's "
                "BA state has one focal per camera"
            )
        return 0.5 * (fx + fy)

    if model == "SIMPLE_PINHOLE":
        return p[0], p[1], p[2], (0.0, 0.0, 0.0, 0.0), "opencv"
    if model == "PINHOLE":
        return _one_focal(p[0], p[1]), p[2], p[3], (0.0, 0.0, 0.0, 0.0), "opencv"
    if model == "SIMPLE_RADIAL":
        return p[0], p[1], p[2], (p[3], 0.0, 0.0, 0.0), "opencv"
    if model == "RADIAL":
        return p[0], p[1], p[2], (p[3], p[4], 0.0, 0.0), "opencv"
    if model == "OPENCV":
        fx, fy, cx, cy, k1, k2, p1, p2 = p
        return _one_focal(fx, fy), cx, cy, (k1, k2, p1, p2), "opencv"
    if model == "OPENCV_FISHEYE":
        fx, fy, cx, cy, k1, k2, k3, k4 = p
        return _one_focal(fx, fy), cx, cy, (k1, k2, k3, k4), "fisheye"
    if model == "FULL_OPENCV":
        # rational model; framework layout (k1..k6, p1, p2)
        fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6 = p
        return (_one_focal(fx, fy), cx, cy,
                (k1, k2, k3, k4, k5, k6, p1, p2), "full_opencv")
    if model == "FOV":
        fx, fy, cx, cy, omega = p
        return _one_focal(fx, fy), cx, cy, (omega, 0.0, 0.0, 0.0), "fov"
    if model == "SIMPLE_RADIAL_FISHEYE":
        # the reduced theta-polynomial (k1 only) is the k2=k3=k4=0 case
        return p[0], p[1], p[2], (p[3], 0.0, 0.0, 0.0), "fisheye"
    if model == "RADIAL_FISHEYE":
        return p[0], p[1], p[2], (p[3], p[4], 0.0, 0.0), "fisheye"
    if model == "THIN_PRISM_FISHEYE":
        # framework layout (k1, k2, k3, k4, p1, p2, sx1, sy1)
        fx, fy, cx, cy, k1, k2, pp1, pp2, k3, k4, sx1, sy1 = p
        return (_one_focal(fx, fy), cx, cy,
                (k1, k2, k3, k4, pp1, pp2, sx1, sy1), "thin_prism")
    raise ValueError(
        f"camera {cam_id}: unsupported COLMAP model {model!r} (supported: "
        "SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL, OPENCV, "
        "OPENCV_FISHEYE, FULL_OPENCV, FOV, SIMPLE_RADIAL_FISHEYE, "
        "RADIAL_FISHEYE, THIN_PRISM_FISHEYE)"
    )


def _parse_colmap_text(model_dir: str):
    """(cam_params, images, pt_ids, pts) from a COLMAP text model."""
    import os

    cam_params: dict[int, tuple] = {}
    for toks in _colmap_tokens(os.path.join(model_dir, "cameras.txt")):
        cam_id, model = int(toks[0]), toks[1]
        p = [float(v) for v in toks[4:]]
        cam_params[cam_id] = _colmap_camera_fk(cam_id, model, p)

    # images.txt alternates a pose line and a 2D-point line.
    images = []  # (image_id, q, t_cw, cam_id, name, [(x, y, pt3d_id)])
    toks_iter = _colmap_tokens(os.path.join(model_dir, "images.txt"))
    for toks in toks_iter:
        image_id = int(toks[0])
        q = np.array([float(v) for v in toks[1:5]])
        t_cw = np.array([float(v) for v in toks[5:8]])
        cam_id = int(toks[8])
        name = toks[9] if len(toks) > 9 else ""
        try:
            pts_toks = next(toks_iter)
        except StopIteration:
            pts_toks = []
        obs = []
        for j in range(0, len(pts_toks) - 2, 3):
            pid = int(pts_toks[j + 2])
            if pid >= 0:
                obs.append((float(pts_toks[j]), float(pts_toks[j + 1]), pid))
        images.append((image_id, q, t_cw, cam_id, name, obs))

    pt_ids = []
    pts = []
    for toks in _colmap_tokens(os.path.join(model_dir, "points3D.txt")):
        pt_ids.append(int(toks[0]))
        pts.append([float(v) for v in toks[1:4]])
    return cam_params, images, pt_ids, pts


def _parse_colmap_bin(model_dir: str):
    """(cam_params, images, pt_ids, pts) from a COLMAP binary model
    (cameras.bin / images.bin / points3D.bin — ``colmap mapper``'s
    native output; layout per COLMAP's reconstruction_io)."""
    import os
    import struct

    def read(fh, fmt):
        return struct.unpack(fmt, fh.read(struct.calcsize(fmt)))

    cam_params: dict[int, tuple] = {}
    with open(os.path.join(model_dir, "cameras.bin"), "rb") as fh:
        (n_cams,) = read(fh, "<Q")
        for _ in range(n_cams):
            cam_id, model_id, _w, _h = read(fh, "<IiQQ")
            model = _COLMAP_MODEL_NAMES.get(model_id)
            if model is None:
                raise ValueError(
                    f"camera {cam_id}: unsupported COLMAP model id "
                    f"{model_id} (supported: {sorted(_COLMAP_MODEL_NAMES)})"
                )
            p = list(read(fh, f"<{_COLMAP_NUM_PARAMS[model]}d"))
            cam_params[cam_id] = _colmap_camera_fk(cam_id, model, p)

    images = []
    with open(os.path.join(model_dir, "images.bin"), "rb") as fh:
        (n_imgs,) = read(fh, "<Q")
        for _ in range(n_imgs):
            (image_id,) = read(fh, "<I")
            q = np.array(read(fh, "<4d"))
            t_cw = np.array(read(fh, "<3d"))
            (cam_id,) = read(fh, "<I")
            name_bytes = bytearray()
            while (ch := fh.read(1)) != b"\x00":
                name_bytes += ch
            (n2d,) = read(fh, "<Q")
            data = np.frombuffer(fh.read(24 * n2d), dtype=np.uint8)
            xy = data.view(np.float64).reshape(n2d, 3)[:, :2]
            pid = data.view(np.int64).reshape(n2d, 3)[:, 2]  # invalid = -1
            obs = [
                (float(xy[j, 0]), float(xy[j, 1]), int(pid[j]))
                for j in range(n2d) if pid[j] >= 0
            ]
            images.append(
                (image_id, q, t_cw, cam_id, name_bytes.decode(), obs)
            )

    pt_ids = []
    pts = []
    with open(os.path.join(model_dir, "points3D.bin"), "rb") as fh:
        (n_pts,) = read(fh, "<Q")
        for _ in range(n_pts):
            pid, px, py, pz = read(fh, "<Q3d")
            _rgb = fh.read(3)
            (_err,) = read(fh, "<d")
            (track_len,) = read(fh, "<Q")
            fh.read(8 * track_len)
            pt_ids.append(int(pid))
            pts.append([px, py, pz])
    return cam_params, images, pt_ids, pts


def load_colmap(model_dir: str) -> dict[str, np.ndarray]:
    """Parse a COLMAP model — binary (``cameras.bin``/``images.bin``/
    ``points3D.bin``, ``colmap mapper``'s native output) or text
    (``cameras.txt``/..., ``colmap model_converter --output_type TXT``),
    auto-detected with binary preferred like COLMAP itself — into the
    framework's dense layout (same keys as :func:`load_bal`).

    Conventions: COLMAP stores world->camera as a (w, x, y, z)
    quaternion + translation with cameras looking down **+z**
    (x_cam = R_cw X + t_cw; pixel = f * x_cam.xy / x_cam.z + c). This
    framework's ``calc_pqr`` uses x_cam = R^T (X - t)
    (``models/bundle_adjustment.py:145``), so R = R_cw^T and
    t = -R_cw^T t_cw; pixels pass through unchanged (+z matches the
    positive-depth convention, unlike BAL's -z), the principal point
    lands in K (the BA state's ``u``), and f0 = 1 (pixel units).

    Camera models: SIMPLE_PINHOLE (f, cx, cy), PINHOLE (fx, fy, cx, cy;
    fx must equal fy — the BA state has one focal per camera),
    SIMPLE_RADIAL (+k -> k1), RADIAL (+k1, k2), and OPENCV (fx, fy, cx,
    cy, k1, k2, p1, p2). The radial model is *exactly* this framework's
    BAL-style distortion: COLMAP distorts the normalized ray as
    x_n (1 + k1 |x_n|^2 + k2 |x_n|^4) before K, which is ``d(s) g`` with
    s = |x_n|^2 (``models/bundle_adjustment.py::_distortion_terms``);
    OPENCV's tangential (p1, p2) terms map to the 4-column model
    (``_tangential_terms``). ``distortion`` comes back (F, 2) for
    radial-only models and (F, 4) when any camera carries tangential
    terms — both feed ``bundle_adjust(distortion=...)`` directly.

    Observations come from the images' 2D points (entries with a
    point3D id of -1 — untriangulated features — are skipped); 3D points
    have their ids remapped to a dense 0..P-1 range (the mapping is
    returned as ``point3d_ids``). Image order follows ascending IMAGE_ID
    (returned as ``image_ids``/``image_names``).
    """
    import os

    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        cam_params, images, pt_ids, pts = _parse_colmap_bin(model_dir)
    else:
        cam_params, images, pt_ids, pts = _parse_colmap_text(model_dir)
    images.sort(key=lambda im: im[0])
    order = np.argsort(pt_ids)
    pt_ids = [pt_ids[i] for i in order]
    pts = np.asarray(pts, np.float64)[order]
    id_to_dense = {pid: i for i, pid in enumerate(pt_ids)}

    nf, npts = len(images), len(pt_ids)
    x = np.zeros((nf, npts, 2))
    vis = np.zeros((npts, nf))
    r_all = np.empty((nf, 3, 3))
    t_all = np.empty((nf, 3))
    k_mats = np.zeros((nf, 3, 3))
    f_all = np.empty(nf)
    dist = np.zeros((nf, 8))
    names = []
    kinds = set()
    for i, (_, q, t_cw, cam_id, name, obs) in enumerate(images):
        r_cw = _quat_to_rotmat(q)
        r_all[i] = r_cw.T
        t_all[i] = -r_cw.T @ t_cw
        f, cx, cy, dk, kind = cam_params[cam_id]
        kinds.add(kind)
        f_all[i] = f
        k_mats[i] = [[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]]
        if kind in ("full_opencv", "thin_prism"):
            dist[i] = dk
        elif kind in ("fisheye", "fov"):
            dist[i, :4] = dk
        else:  # opencv family (k1, k2, p1, p2) -> rational-compatible slots
            dist[i, 0:2] = dk[0:2]
            dist[i, 6:8] = dk[2:4]
        names.append(name)
        for px, py, pid in obs:
            if pid in id_to_dense:
                j = id_to_dense[pid]
                x[i, j] = (px, py)
                vis[j, i] = 1.0

    if kinds == {"thin_prism"}:
        dist_model = "thin_prism"
    elif "thin_prism" in kinds:
        raise ValueError(
            "COLMAP model mixes THIN_PRISM_FISHEYE and other cameras; "
            "the BA distortion model is per-reconstruction"
        )
    elif kinds == {"fov"}:
        dist = dist[:, :1]  # (omega,)
        dist_model = "fov"
    elif "fov" in kinds:
        raise ValueError(
            "COLMAP model mixes FOV and non-FOV cameras; the BA "
            "distortion model is per-reconstruction"
        )
    elif kinds == {"fisheye"}:
        # equidistant cameras: all four theta-polynomial columns stay,
        # and the caller must run with distortion_model="fisheye"
        dist = dist[:, :4]
        dist_model = "fisheye"
    elif "fisheye" in kinds:
        raise ValueError(
            "COLMAP model mixes fisheye and perspective cameras; the BA "
            "distortion model is per-reconstruction"
        )
    elif "full_opencv" in kinds:
        # an OPENCV camera is FULL_OPENCV with k3..k6 = 0, so mixed
        # perspective models promote to the 8-column rational layout
        dist_model = "full_opencv"
    elif dist[:, 6:8].any():
        dist = np.concatenate([dist[:, 0:2], dist[:, 6:8]], axis=-1)
        dist_model = "opencv"
    else:
        # radial-only models keep the (F, 2) layout (the BA cores select
        # the OPENCV tangential path from the 4-column shape)
        dist = dist[:, :2]
        dist_model = "radial"

    return {
        "x": x, "visibility": vis, "X": pts, "R": r_all, "t": t_all,
        "K": k_mats, "f": f_all, "distortion": dist,
        "distortion_model": np.str_(dist_model),
        "f0": np.asarray(1.0),
        "image_ids": np.array([im[0] for im in images], np.int64),
        "image_names": np.array(names),
        "point3d_ids": np.array(pt_ids, np.int64),
    }


def save_colmap(model_dir: str, x, visibility, X, R, t, f,
                principal_point=None, distortion=None,
                image_size=None, binary: bool = False,
                distortion_model: str | None = None) -> None:
    """Write a COLMAP model — text, or binary with ``binary=True``
    (COLMAP's native layout, loadable by ``colmap`` directly) — the
    inverse of :func:`load_colmap`'s conventions; quaternions via the
    angle-stable largest-component extraction. One camera entry per
    image; RADIAL when ``distortion`` is (F, 2), OPENCV when (F, 4),
    SIMPLE_PINHOLE otherwise. ``distortion_model="fisheye"`` writes the
    four columns as OPENCV_FISHEYE (k1..k4) instead. ``image_size``
    defaults to a bound derived from the observations."""
    import os
    import struct

    os.makedirs(model_dir, exist_ok=True)
    x = np.asarray(x)
    vis = np.asarray(visibility)
    X = np.asarray(X)
    R = np.asarray(R)
    t = np.asarray(t)
    f = np.asarray(f)
    nf, npts = x.shape[0], x.shape[1]
    pp = (
        np.zeros((nf, 2)) if principal_point is None
        else np.asarray(principal_point)
    )
    dist = None if distortion is None else np.asarray(distortion)
    if image_size is None:
        seen = vis.T > 0  # (F, P)
        bound = int(np.ceil(2.0 * np.abs(x[seen]).max())) + 1 if seen.any() else 1
        image_size = (bound, bound)
    w_px, h_px = int(image_size[0]), int(image_size[1])

    if dist is not None and dist.shape[-1] == 1:
        model = "FOV"  # fx fy cx cy omega
        cam_param_rows = [
            [float(f[i]), float(f[i]), float(pp[i, 0]), float(pp[i, 1]),
             float(dist[i, 0])]
            for i in range(nf)
        ]
    elif dist is None:
        model = "SIMPLE_PINHOLE"
        cam_param_rows = [
            [float(f[i]), float(pp[i, 0]), float(pp[i, 1])]
            for i in range(nf)
        ]
    elif dist.shape[-1] == 8:
        if distortion_model == "thin_prism":
            # fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1 from the framework
            # layout (k1, k2, k3, k4, p1, p2, sx1, sy1)
            model = "THIN_PRISM_FISHEYE"
            cam_param_rows = [
                [float(f[i]), float(f[i]), float(pp[i, 0]), float(pp[i, 1]),
                 float(dist[i, 0]), float(dist[i, 1]),
                 float(dist[i, 4]), float(dist[i, 5]),
                 float(dist[i, 2]), float(dist[i, 3]),
                 float(dist[i, 6]), float(dist[i, 7])]
                for i in range(nf)
            ]
        else:
            model = "FULL_OPENCV"  # fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
            cam_param_rows = [
                [float(f[i]), float(f[i]), float(pp[i, 0]), float(pp[i, 1]),
                 float(dist[i, 0]), float(dist[i, 1]),
                 float(dist[i, 6]), float(dist[i, 7]),
                 float(dist[i, 2]), float(dist[i, 3]),
                 float(dist[i, 4]), float(dist[i, 5])]
                for i in range(nf)
            ]
    elif dist.shape[-1] == 4:
        if distortion_model == "fisheye":
            model = "OPENCV_FISHEYE"  # fx fy cx cy k1 k2 k3 k4 (fx = fy)
        else:
            model = "OPENCV"  # fx fy cx cy k1 k2 p1 p2 (fx = fy here)
        cam_param_rows = [
            [float(f[i]), float(f[i]), float(pp[i, 0]), float(pp[i, 1]),
             float(dist[i, 0]), float(dist[i, 1]),
             float(dist[i, 2]), float(dist[i, 3])]
            for i in range(nf)
        ]
    else:
        if distortion_model == "fisheye":
            raise ValueError("fisheye distortion requires 4 columns (k1..k4)")
        model = "RADIAL"
        cam_param_rows = [
            [float(f[i]), float(pp[i, 0]), float(pp[i, 1]),
             float(dist[i, 0]), float(dist[i, 1])]
            for i in range(nf)
        ]
    poses = []
    for i in range(nf):
        r_cw = R[i].T
        poses.append((_rotmat_to_quat(r_cw), -r_cw @ t[i]))

    if binary:
        with open(os.path.join(model_dir, "cameras.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", nf))
            for i in range(nf):
                fh.write(struct.pack(
                    "<IiQQ", i + 1, _COLMAP_MODEL_IDS[model], w_px, h_px
                ))
                fh.write(struct.pack(
                    f"<{len(cam_param_rows[i])}d", *cam_param_rows[i]
                ))
        with open(os.path.join(model_dir, "images.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", nf))
            for i in range(nf):
                q, t_cw = poses[i]
                fh.write(struct.pack("<I", i + 1))
                fh.write(struct.pack("<4d", *q))
                fh.write(struct.pack("<3d", *t_cw))
                fh.write(struct.pack("<I", i + 1))
                fh.write(f"image{i:05d}.png".encode() + b"\x00")
                js = np.nonzero(vis[:, i] > 0)[0]
                fh.write(struct.pack("<Q", len(js)))
                for j in js:
                    fh.write(struct.pack(
                        "<2dq", float(x[i, j, 0]), float(x[i, j, 1]), j + 1
                    ))
        with open(os.path.join(model_dir, "points3D.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", npts))
            for j in range(npts):
                fh.write(struct.pack("<Q3d", j + 1, *(float(v) for v in X[j])))
                fh.write(bytes((128, 128, 128)))
                fh.write(struct.pack("<d", 0.0))
                is_ = np.nonzero(vis[j] > 0)[0]
                fh.write(struct.pack("<Q", len(is_)))
                for i in is_:
                    fh.write(struct.pack("<II", i + 1, 0))
        return

    lines = ["# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]"]
    for i in range(nf):
        lines.append(
            f"{i + 1} {model} {w_px} {h_px} "
            + " ".join(repr(v) for v in cam_param_rows[i])
        )
    with open(os.path.join(model_dir, "cameras.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")

    lines = ["# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)"]
    for i in range(nf):
        q, t_cw = poses[i]
        lines.append(
            f"{i + 1} " + " ".join(repr(float(v)) for v in q) + " "
            + " ".join(repr(float(v)) for v in t_cw)
            + f" {i + 1} image{i:05d}.png"
        )
        obs = [
            f"{float(x[i, j, 0])!r} {float(x[i, j, 1])!r} {j + 1}"
            for j in np.nonzero(vis[:, i] > 0)[0]
        ]
        lines.append(" ".join(obs))
    with open(os.path.join(model_dir, "images.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")

    lines = ["# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]"]
    for j in range(npts):
        track = " ".join(
            f"{i + 1} 0" for i in np.nonzero(vis[j] > 0)[0]
        )
        lines.append(
            f"{j + 1} " + " ".join(repr(float(v)) for v in X[j])
            + " 128 128 128 0.0 " + track
        )
    with open(os.path.join(model_dir, "points3D.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def save_ply(path: str, X, colors=None, cameras=None,
             quality=None) -> None:
    """Write a reconstruction as an ASCII PLY point cloud — the standard
    interchange viewable in MeshLab / CloudCompare / Open3D.

    ``X`` (P, 3) points; ``colors`` optional (P, 3) uint8 (default mid
    gray); ``cameras`` optional (F, 3) camera centers appended as red
    points so pose geometry is visible alongside the cloud.

    ``quality`` optional (P,) per-point scalar (e.g. the position sigma
    from ``ba_covariance``) written as a float ``quality`` vertex
    property (the MeshLab/CloudCompare scalar-field convention) —
    appended cameras get quality 0. When ``colors`` is omitted and
    ``quality`` is given, points are also colored on a white->red ramp
    by quality so the uncertainty is visible without loading the scalar
    field."""
    X = np.asarray(X, np.float64)
    npts = X.shape[0]
    q = None if quality is None else np.asarray(quality, np.float64)
    if colors is None:
        if q is not None:
            qf = np.nan_to_num(q, nan=0.0, posinf=0.0, neginf=0.0)
            hi = float(qf.max()) if qf.size and float(qf.max()) > 0 else 1.0
            w = np.clip(qf / hi, 0.0, 1.0)
            cols = np.stack([
                np.full(npts, 255), 255 * (1.0 - w), 255 * (1.0 - w)
            ], axis=-1).astype(np.uint8)
        else:
            cols = np.full((npts, 3), 200, np.uint8)
    else:
        cols = np.asarray(colors, np.uint8)
    rows = [X]
    crows = [cols]
    qrows = None if q is None else [q]
    if cameras is not None:
        cams = np.asarray(cameras, np.float64)
        rows.append(cams)
        crows.append(
            np.tile(np.array([[255, 40, 40]], np.uint8), (cams.shape[0], 1))
        )
        if qrows is not None:
            qrows.append(np.zeros(cams.shape[0]))
    pts = np.concatenate(rows)
    cols = np.concatenate(crows)
    qs = None if qrows is None else np.concatenate(qrows)
    lines = [
        "ply", "format ascii 1.0",
        f"element vertex {pts.shape[0]}",
        "property double x", "property double y", "property double z",
        "property uchar red", "property uchar green", "property uchar blue",
    ]
    if qs is not None:
        lines.append("property float quality")
    lines.append("end_header")
    for i, (p, c) in enumerate(zip(pts, cols)):
        row = (
            f"{float(p[0])!r} {float(p[1])!r} {float(p[2])!r} "
            f"{int(c[0])} {int(c[1])} {int(c[2])}"
        )
        if qs is not None:
            row += f" {float(qs[i])!r}"
        lines.append(row)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
