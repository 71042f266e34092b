"""The port's BA covariance (``models/covariance.py``) in float64 on the
CPU, held against the JAX package on the same numpy inputs and against
autograd:

- ``ba_covariance``, plain and Huber, with and without a visibility mask:
  the blocks to rtol 1e-8 of JAX's, sigma^2, n_obs and E;
- ``ba_covariance_chunked`` (ragged chunks, visibility) against JAX's and
  against the port's dense; ``ba_covariance_streamed`` (visibility and
  Huber, and without a mask) against the port's dense;
- lanes: a batch of scenes equals the per-scene calls;
- the global-frame transform, as ``tests/test_covariance.py`` checks it;
- an autograd oracle: 2 sigma^2 times the inverse of
  ``torch.autograd.functional.hessian`` of E over the gauge-free
  parameters equals the blocks;
- ``distortion=`` with each family of the second slice (fisheye, full
  OPENCV, FOV, thin prism), which raised here before, on all three against
  JAX's ``ba_covariance`` (rtol 1e-8).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import covariance as jcov
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models import covariance as tcov
from mvrecon_tpu_torch.ops.rotations import rodrigues

AXIS = "x-right_z-forward"
HUBER = dict(robust="huber", huber_delta=0.002)
BLOCKS = ("point_cov", "camera_cov")

_scene = jax.jit(make_synthetic_scene,
                 static_argnames=("n_images", "n_slices", "n_angles", "dtype"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solved(seed=0, n_images=6, n_slices=3, n_angles=10, vis=None):
    """Observations (P, F, 2) of an exact render plus 0.002 N(0, 1) noise
    and the port's BA optimum from the true start: (x, X, K, R, t) as
    numpy."""
    sc = _scene(jax.random.key(seed), n_images=n_images, n_slices=n_slices,
                n_angles=n_angles, noise=0.0, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    x = np.asarray(sc.x).transpose(1, 0, 2)
    x = x + 0.002 * rng.standard_normal(x.shape)
    res = tba.bundle_adjust(x, *(np.asarray(a) for a in (sc.X, sc.K, sc.R, sc.t)),
                            visibility=vis, axis=AXIS, device="cpu",
                            config=LMConfig(max_iter=30, delta_tol=1e-14))
    return (x,) + tuple(a.numpy() for a in (res.X, res.K, res.R, res.t))


def _mask(shape, keep=0.8):
    vis = (np.random.default_rng(3).uniform(size=shape) < keep).astype(np.float64)
    vis[:, :2] = 1.0  # every point needs two views for a determined position
    return vis


@pytest.fixture(scope="module")
def masked():
    vis = _mask((27, 5))
    return _solved(n_images=5, n_angles=9, vis=vis), vis


def _close(got, want, rtol=1e-8):
    """To rtol of the largest entry: the same float64 algebra, summed in
    another order."""
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max())


def _same_cov(got, want, rtol=1e-8):
    for k in BLOCKS:
        _close(getattr(got, k), getattr(want, k), rtol)
    np.testing.assert_allclose(float(got.sigma2), float(want.sigma2), rtol=1e-10)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-10)
    assert int(got.n_obs) == int(want.n_obs)


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "huber"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["full", "masked"])
def test_ba_covariance_matches_jax(masked, robust, with_mask):
    prob, vis = masked
    vis = vis if with_mask else None
    fields = HUBER if robust else {}
    want = jcov.ba_covariance(*(jnp.asarray(a) for a in prob), axis=AXIS,
                              visibility=None if vis is None else jnp.asarray(vis),
                              config=JLMConfig(**fields))
    got = tcov.ba_covariance(*prob, axis=AXIS, visibility=vis, config=LMConfig(**fields),
                             device="cpu")
    _same_cov(got, want)
    if robust:  # the weights bite: a weighted E below the plain one
        plain = tcov.ba_covariance(*prob, axis=AXIS, visibility=vis, device="cpu")
        assert float(got.error) < 0.99 * float(plain.error)


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "huber"])
def test_chunked_matches_jax_and_dense(masked, robust):
    prob, vis = masked
    fields = HUBER if robust else {}
    want = jcov.ba_covariance_chunked(*(jnp.asarray(a) for a in prob), axis=AXIS,
                                      visibility=jnp.asarray(vis), config=JLMConfig(**fields),
                                      chunk_size=8)
    got = tcov.ba_covariance_chunked(*prob, axis=AXIS, visibility=vis,
                                     config=LMConfig(**fields), chunk_size=8, device="cpu")
    _same_cov(got, want)
    dense = tcov.ba_covariance(*prob, axis=AXIS, visibility=vis, config=LMConfig(**fields),
                               device="cpu")
    _same_cov(got, dense)


@pytest.mark.parametrize("with_mask", [True, False], ids=["masked-huber", "full-plain"])
def test_streamed_matches_dense(masked, with_mask):
    """Host observations through the chunk feed (ragged chunks of 8) equal
    the dense blocks. Without a mask n_obs is P F, as in the dense path
    (JAX's streamed variant counts the (C, 1) chunk column there)."""
    prob, vis = masked
    vis = vis if with_mask else None
    cfg = LMConfig(**HUBER) if with_mask else LMConfig()
    got = tcov.ba_covariance_streamed(*prob, axis=AXIS, visibility=vis, config=cfg,
                                      chunk_size=8, dtype=torch.float64, device="cpu")
    dense = tcov.ba_covariance(*prob, axis=AXIS, visibility=vis, config=cfg, device="cpu")
    _same_cov(got, dense)
    if not with_mask:
        assert int(got.n_obs) == prob[0].shape[0] * prob[0].shape[1]


def test_lanes_equal_per_scene_calls():
    """Batched and single products sum in other orders, and A's inverse
    amplifies that by its condition: equal to the parity tolerance."""
    probs = [_solved(seed=s, n_images=5, n_slices=2, n_angles=8) for s in range(3)]
    batch = [np.stack(a) for a in zip(*probs)]
    got = tcov.ba_covariance(*batch, config=LMConfig(**HUBER), device="cpu")
    assert got.point_cov.shape == (3, 16, 3, 3) and got.camera_cov.shape == (3, 5, 9, 9)
    assert got.sigma2.shape == got.n_obs.shape == (3,)
    for i, prob in enumerate(probs):
        one = tcov.ba_covariance(*prob, config=LMConfig(**HUBER), device="cpu")
        for k in BLOCKS + ("sigma2", "error"):
            _close(getattr(got, k)[i], getattr(one, k))
        assert int(got.n_obs[i]) == int(one.n_obs)


def test_global_frame_transform():
    """The blocks of a global-frame state are the normalized-frame blocks
    pushed through the gauge similarity: points and translations by
    scale R0, rotations by R0."""
    x, X, K, R, t = _solved()
    cov_g = tcov.ba_covariance(x, X, K, R, t, axis=AXIS, device="cpu")
    Xn, Rn, tn, info = tba.normalize_gauge(*(torch.from_numpy(a) for a in (X, R, t)), AXIS)
    cov_n = tcov.ba_covariance(x, Xn, K, Rn, tn, axis=AXIS, device="cpu")
    r0 = info["R0"].numpy()
    m = float(info["scale"]) * r0
    _close(cov_g.point_cov, np.einsum("ij,pjk,lk->pil", m, cov_n.point_cov.numpy(), m), 1e-10)
    tmat = np.zeros((9, 9))
    tmat[:3, :3] = np.eye(3)
    tmat[3:6, 3:6] = m
    tmat[6:9, 6:9] = r0
    _close(cov_g.camera_cov, np.einsum("ij,fjk,lk->fil", tmat, cov_n.camera_cov.numpy(), tmat),
           1e-10)


def test_autograd_hessian_oracle():
    """2 sigma^2 H^-1 over the gauge-free parameters, with H the autograd
    Hessian of E, equals the Schur-based blocks on the normalized state.
    E is taken against the model's own projections at the optimum, so its
    Hessian there is exactly the Gauss-Newton 2 J^T J (the residuals that
    multiply the second derivatives are zero)."""
    x, X, K, R, t = _solved()
    Xn, Rn, tn, _ = tba.normalize_gauge(*(torch.from_numpy(a) for a in (X, R, t)), AXIS)
    npts, nf = Xn.shape[0], Rn.shape[0]
    cov = tcov.ba_covariance(x, Xn, K, Rn, tn, axis=AXIS, device="cpu")
    f, u = tba.intrinsics_from_K(torch.from_numpy(K), 1.0)
    vis = torch.ones(npts, nf, dtype=torch.float64)

    def state_of(flat):
        cam = flat[3 * npts:].view(nf, 9)
        return tba.BAState(X=flat[:3 * npts].view(npts, 3), f=cam[:, 0], u=cam[:, 1:3],
                           t=cam[:, 3:6], R=rodrigues(cam[:, 6:9]) @ Rn)

    flat0 = torch.cat([Xn.reshape(-1), torch.cat(
        [f[:, None], u, tn, torch.zeros(nf, 3, dtype=torch.float64)], dim=1).reshape(-1)])
    res_p, res_q = tba._residuals(state_of(flat0), torch.zeros(npts, nf, 2, dtype=torch.float64),
                                  vis, 1.0)
    x_model = torch.stack([res_p, res_q], dim=-1)  # the projections at the optimum

    free = torch.cat([torch.ones(3 * npts, dtype=torch.float64),
                      tba.gauge_mask(nf, AXIS, torch.float64)]).bool()
    idx = torch.nonzero(free).flatten()

    def energy(theta):
        flat = flat0.index_put((idx,), theta)
        return tba._state_error(state_of(flat), x_model, vis, 1.0)

    hess = torch.autograd.functional.hessian(energy, flat0[idx])
    e = float(tba._state_error(state_of(flat0), torch.from_numpy(x), vis, 1.0))
    sigma2 = e / (2 * npts * nf - idx.numel())
    np.testing.assert_allclose(float(cov.sigma2), sigma2, rtol=1e-10)

    n = free.numel()
    full = torch.zeros(n, n, dtype=torch.float64)
    full[idx[:, None], idx[None, :]] = 2.0 * sigma2 * torch.linalg.inv(hess)
    pc = torch.stack([full[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(npts)])
    o = 3 * npts
    cc = torch.stack([full[o + 9 * k:o + 9 * k + 9, o + 9 * k:o + 9 * k + 9] for k in range(nf)])
    np.testing.assert_allclose(cov.point_cov.numpy(), pc.numpy(), rtol=1e-6, atol=1e-14)
    np.testing.assert_allclose(cov.camera_cov.numpy(), cc.numpy(), rtol=1e-6, atol=1e-14)


@pytest.mark.parametrize("fn", [tcov.ba_covariance, tcov.ba_covariance_chunked,
                                functools.partial(tcov.ba_covariance_streamed,
                                                  dtype=torch.float64)],
                         ids=["dense", "chunked", "streamed"])
def test_distortion_raises(fn):
    """The distortion families of the second slice, which raised here
    before, give JAX's blocks, sigma^2 and E, on the observations mapped
    through each model (``distort_points``), so that the solution stays
    at the optimum. 30 points in 6 views: on 8 points in 4 the inverse
    lifted the blocks' 1e-15 agreement to 2e-8 of the largest entry for
    FOV and thin prism, whose parameters nearly trade off with f there."""
    x_pin, X, K, R, t = _solved()
    f, u = (torch.from_numpy(a) for a in (K[:, 0, 0], K[:, :2, 2]))
    for model, ncols in (("fisheye", 4), ("full_opencv", 8), ("fov", 1), ("thin_prism", 8)):
        dist = np.full((6, ncols), 0.9 if model == "fov" else 0.01)
        x = tba.distort_points(torch.from_numpy(x_pin), f, u, 1.0, torch.from_numpy(dist),
                               model).numpy()
        want = jcov.ba_covariance(*map(jnp.asarray, (x, X, K, R, t)), axis=AXIS,
                                  distortion=jnp.asarray(dist),
                                  config=JLMConfig(distortion_model=model))
        got = fn(x, X, K, R, t, distortion=dist, axis=AXIS,
                 config=LMConfig(distortion_model=model), device="cpu")
        for k in BLOCKS:
            w = np.asarray(getattr(want, k))
            np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=0,
                                       atol=1e-8 * np.abs(w).max(), err_msg=f"{model} {k}")
        np.testing.assert_allclose(float(got.sigma2), float(want.sigma2), rtol=1e-8)
        np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-8)
