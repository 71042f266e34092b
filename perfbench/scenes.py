"""The benchmark's input generators, copied from the program so that a
change to the program cannot move the yardstick.

Sources: ``mvrecon_tpu_torch/geometry/scenes.py`` and ``camera.py`` (the
reference's curved-tube scene, ``lib/utils.py:55-63``: hemisphere cameras
at radius 5 looking at N(0, 0.5) targets, world-top +X, f = f0 = 1),
``chip_smoke.batched_scenes`` (scenes drawn in turn from one generator),
``chip_smoke.sparse_problem`` (the BAL-class list of
``bench.py::bench_bal_large`` drawn on the card) and phase 4b's 1M x 500
draw. Every draw comes from a ``torch.Generator`` on the device that runs
the cell, so a seed gives the same inputs there every time. A cell's
problems are drawn from the seeds its traffic file fixes, and ``--seed``
draws their order (``order``): a solver's work follows its data
(retries, CG and depth iterations), so fresh data per seed would change
the work from run to run. Plain PyTorch; nothing of the program is
imported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def curved_tube_points(n_slices: int, n_angles: int, dtype=torch.float32, device=None):
    """``n_slices`` x-slices in [-1, 1] x ``n_angles`` angles in
    [pi/2, 3pi/2], radius 1/(x+2) -> (n_slices * n_angles, 3)."""
    x = torch.linspace(-1.0, 1.0, n_slices, dtype=dtype, device=device)
    theta = torch.linspace(math.pi / 2, 3 * math.pi / 2, n_angles, dtype=dtype, device=device)
    r = 1.0 / (x + 2.0)
    xx = x.repeat_interleave(n_angles)
    rr = r.repeat_interleave(n_angles)
    tt = theta.repeat(n_slices)
    return torch.stack([xx, rr * torch.cos(tt), rr * torch.sin(tt)], dim=-1)


def hemisphere_points(gen: torch.Generator, num: int, r: float, dtype=torch.float32):
    """``num`` random positions on the radius-``r`` hemisphere with x >= 0."""
    dev = gen.device
    theta = torch.rand(num, generator=gen, dtype=dtype, device=dev) * (math.pi / 2)
    phi = torch.rand(num, generator=gen, dtype=dtype, device=dev) * (2 * math.pi)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta) * torch.cos(phi),
                        r * torch.sin(theta) * torch.sin(phi)], dim=-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def look_at(origin: torch.Tensor, target: torch.Tensor):
    """(R, t) from camera positions and targets, world-top = +X: the
    columns of R are the camera's x, y, z axes in the world, t its centre."""
    top = torch.tensor([1.0, 0.0, 0.0], dtype=origin.dtype, device=origin.device)
    z = _unit(target - origin)
    y = _unit(torch.linalg.cross(z, top.expand_as(z)))
    x = _unit(torch.linalg.cross(y, z))
    return torch.stack([x, y, z], dim=-1), origin


def project(X: torch.Tensor, f: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Pinhole projection of points X (P, 3) through cameras (F,) with
    principal point 0 and f0 = 1 -> (F, P, 2)."""
    xc = torch.einsum("fji,fpj->fpi", R, X[None] - t[:, None])
    return f[:, None, None] * xc[..., :2] / xc[..., 2:3]


class Scene(NamedTuple):
    """One tube scene: truth and noisy observations x (F, P, 2)."""

    X: torch.Tensor
    f: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    x: torch.Tensor


def tube_scene(gen: torch.Generator, n_images: int, n_slices: int, noise: float,
               n_angles: int = 20) -> Scene:
    """The reference demo scene (``make_synthetic_scene``'s draw order: the
    camera positions, the targets, then the image noise), float32."""
    dev = gen.device
    pos = hemisphere_points(gen, n_images, 5.0)
    targets = 0.5 * torch.randn(n_images, 3, generator=gen, device=dev)
    R, t = look_at(pos, targets)
    f = torch.ones(n_images, device=dev)
    X = curved_tube_points(n_slices, n_angles, device=dev)
    x = project(X, f, R, t)
    x = x + noise * torch.randn(x.shape, generator=gen, device=dev)
    return Scene(X, f, R, t, x)


def batched_scenes(gen: torch.Generator, n_scenes: int, n_images: int, n_slices: int,
                   noise: float) -> Scene:
    """S tube scenes drawn in turn from one generator, stacked on a leading
    axis (X is shared: the tube is the same in every scene)."""
    scenes = [tube_scene(gen, n_images, n_slices, noise) for _ in range(n_scenes)]
    return Scene(scenes[0].X, *(torch.stack([getattr(s, k) for s in scenes])
                                for k in ("f", "R", "t", "x")))


def order(seed: int, n: int, device) -> torch.Tensor:
    """The permutation of n items that ``--seed`` draws."""
    return torch.randperm(n, generator=generator(seed, device), device=device)


def permuted_scenes(sc: Scene, perm: torch.Tensor) -> Scene:
    """The batch's scenes in the order ``perm``."""
    return Scene(sc.X, sc.f[perm], sc.R[perm], sc.t[perm], sc.x[perm])


def perturbed(gen: torch.Generator, a: torch.Tensor, sigma: float) -> torch.Tensor:
    return a + sigma * torch.randn(a.shape, generator=gen, dtype=a.dtype, device=a.device)


class WindowList(NamedTuple):
    """An observation list in which point p is seen by the ``window``
    consecutive cameras lo[p] .. lo[p] + window - 1, sorted by point: xy is
    (2, P * window), point_idx and cam_idx (P * window,) int32."""

    point_idx: torch.Tensor
    cam_idx: torch.Tensor
    xy: torch.Tensor
    lo: torch.Tensor
    window: int


def project_list(X, f, R, t, pi, ci, chunk: int = 1 << 22):
    """(2, N) projections of the points ``pi`` through the cameras ``ci``."""
    out = torch.empty((2, pi.shape[0]), dtype=X.dtype, device=X.device)
    for s in range(0, pi.shape[0], chunk):
        c = ci[s:s + chunk].long()
        xc = torch.einsum("nji,nj->ni", R[c], X[pi[s:s + chunk].long()] - t[c])
        out[:, s:s + chunk] = (f[c, None] * xc[:, :2] / xc[:, 2:3]).T
    return out


def bal_class_problem(gen: torch.Generator, n_cams: int, n_points: int, window: int,
                      noise: float, outlier_share: float, outlier_sigma: float,
                      start_sigma: float):
    """``chip_smoke.sparse_problem``'s draw: ``n_cams`` hemisphere cameras
    at radius 5 looking at 0.5 N(0, 1) targets, f = 1, the curved tube
    (n_points // 20 slices x 20 angles), each point seen by ``window``
    consecutive cameras from a random start, sigma noise, a share of the
    observations moved by ``outlier_sigma`` N(0, 1), X and t perturbed by
    ``start_sigma`` N(0, 1). Returns (list, truth (X, f, R, t), start (X0,
    f, R, t0))."""
    dev = gen.device
    pos = hemisphere_points(gen, n_cams, 5.0)
    R, t = look_at(pos, 0.5 * torch.randn(n_cams, 3, generator=gen, device=dev))
    f = torch.ones(n_cams, device=dev)
    X = curved_tube_points(n_points // 20, 20, device=dev)
    npts = X.shape[0]
    lo = torch.randint(0, n_cams - window + 1, (npts,), generator=gen, device=dev,
                       dtype=torch.int32)
    pi = torch.arange(npts, device=dev, dtype=torch.int32).repeat_interleave(window)
    ci = (lo[:, None] + torch.arange(window, device=dev, dtype=torch.int32)).reshape(-1)
    xy = project_list(X, f, R, t, pi, ci)
    n_obs = pi.shape[0]
    xy += noise * torch.randn((2, n_obs), generator=gen, device=dev)
    outlier = torch.rand(n_obs, generator=gen, device=dev) < outlier_share
    xy += torch.where(outlier, outlier_sigma * torch.randn((2, n_obs), generator=gen, device=dev),
                      0.0)
    X0 = perturbed(gen, X, start_sigma)
    t0 = perturbed(gen, t, start_sigma)
    return WindowList(pi, ci, xy, lo, window), (X, f, R, t), (X0, f, R, t0)


def streamed_problem(gen: torch.Generator, n_images: int, n_points: int, noise: float,
                     start_sigma: float, seed: int | None = None):
    """Phase 4b's problem: the tube scene at ``n_points`` x ``n_images``
    drawn on the device, its observations moved to host memory as a (P, F,
    2) float32 NumPy array (never whole on the card again), X and t
    perturbed by ``start_sigma`` N(0, 1); with ``seed``, the points in the
    order that it draws. Returns (x_host, truth, start)."""
    sc = tube_scene(gen, n_images, n_points // 20, noise)
    X0 = perturbed(gen, sc.X, start_sigma)
    t0 = perturbed(gen, sc.t, start_sigma)
    if seed is not None:
        perm = order(seed, sc.X.shape[0], sc.X.device)
        sc = sc._replace(X=sc.X[perm], x=sc.x[:, perm])
        X0 = X0[perm]
    x_host = np.empty((sc.X.shape[0], n_images, 2), dtype=np.float32)
    dst = torch.from_numpy(x_host)
    step = 1 << 16
    for lo in range(0, sc.X.shape[0], step):  # transposed on the card a slab at a time
        dst[lo:lo + step].copy_(sc.x[:, lo:lo + step].transpose(0, 1).contiguous())
    truth = (sc.X, sc.f, sc.R, sc.t)
    return x_host, truth, (X0, sc.f, sc.R, t0)
