"""Parity of the port's perspective pipelines with the JAX package, in
float64 on the CPU, on the same numpy observations:

- ``euclidean_reconstruction`` (self-calibration, then dense BA) for each
  ``eig_method``: the same calibration status and BA iterations, final E
  to 1e-6 and the reprojections of the result to 1e-6 (calibration may
  hand BA a sign-mirrored but E-identical start, see
  test_torch_perspective.py, so X itself is not compared);
- ``euclidean_reconstruction_large`` with the camera bootstrap (chunked
  BA on a point subsample, DLT re-triangulation, then chunked BA): the
  same status, iterations and solver retries, final E to 1e-6;
- a scene whose observations are all NaN: the calibration flags it
  (status 2) and E is not finite, on both sides, and nothing raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.pipelines import euclidean_reconstruction as j_pipeline
from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large as j_large
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction as t_pipeline
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction_large as t_large
from mvrecon_tpu_torch.runtime.profiling import StageTimer


def _observations(n_images, n_slices, seed):
    sc = make_synthetic_scene(jax.random.key(seed), n_images=n_images, n_slices=n_slices,
                              n_angles=20, dtype=jnp.float64)
    return np.asarray(sc.x)  # (F, P, 2)


def _project(X, K, R, t):
    rt = np.swapaxes(R, -1, -2)
    P = K @ np.concatenate([rt, -(rt @ t[..., None])], axis=-1)
    ph = np.einsum("fij,pj->fpi", P, np.concatenate([X, np.ones((X.shape[0], 1))], axis=-1))
    return ph[..., :2] / ph[..., 2:]


def _floor(x):
    return x.shape[0] * x.shape[1] * 2 * 0.005**2


@pytest.mark.parametrize("eig_method", ["eigh", "lowrank", "power"])
def test_euclidean_reconstruction_matches_jax(eig_method):
    x = _observations(10, 10, seed=123)  # the JAX CLI's default scene
    want = j_pipeline(jnp.asarray(x), eig_method=eig_method)
    timer = StageTimer()
    got = t_pipeline(x, eig_method=eig_method, device="cpu", timer=timer)
    assert got.status == int(want.status) == 0
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-6)
    np.testing.assert_allclose(
        _project(*(a.numpy() for a in (got.X, got.K, got.R, got.t))),
        _project(*(np.asarray(a) for a in (want.X, want.K, want.R, want.t))),
        rtol=1e-6, atol=1e-9,
    )
    assert set(timer.times) == {"perspective_self_calibration", "bundle_adjustment"}
    assert set(got.ba_log) == {"c", "nu", "n_solver_retries"}
    assert float(got.error) < 1.2 * _floor(x)


def test_camera_bootstrap_matches_jax():
    x = _observations(12, 20, seed=2)  # (12, 400, 2): a 200-point subsample
    fields = dict(scale_factor=4.0, delta_tol=0.0, max_iter=4, accept_divisor=1.0,
                  init_damping=3e-3, damping="nielsen")
    want = j_large(jnp.asarray(x), config=JLMConfig(**fields), chunk_size=128,
                   bootstrap_iters=4)
    timer = StageTimer()
    got = t_large(x, config=LMConfig(**fields), chunk_size=128, bootstrap_iters=4,
                  device="cpu", timer=timer)
    assert got.status == int(want.status) == 0
    assert got.n_iter == int(want.n_iter)
    assert got.ba_log["n_solver_retries"] == int(want.ba_log["n_solver_retries"])
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-6)
    assert set(timer.times) == {"perspective_self_calibration", "camera_bootstrap_ba",
                                "retriangulate", "bundle_adjustment"}
    assert float(got.error) < 1.2 * _floor(x)


def test_non_finite_scene_is_flagged_not_raised():
    x = np.full_like(_observations(6, 10, seed=123), np.nan)
    fields = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=5)
    want = j_pipeline(jnp.asarray(x), method="dual", config=JLMConfig(**fields))
    got = t_pipeline(x, method="dual", config=LMConfig(**fields), device="cpu")
    assert got.status == int(want.status) == 2
    assert not np.isfinite(float(got.error)) and not np.isfinite(float(want.error))
