"""Parity of the port's large perspective pipeline (self-calibration, then
chunked BA) with the JAX package's ``euclidean_reconstruction_large``, in
float64 on the CPU, on the same numpy observations: the same calibration
status and BA iterations, final E to 1e-6 (calibration may hand BA a
sign-mirrored but E-identical start, see test_torch_perspective.py)."""

import numpy as np
import jax
import jax.numpy as jnp

from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large as j_pipeline
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction_large as t_pipeline
from mvrecon_tpu_torch.runtime.profiling import StageTimer


def test_euclidean_reconstruction_large_matches_jax():
    sc = make_synthetic_scene(jax.random.key(2), n_images=12, n_slices=20, n_angles=20,
                              dtype=jnp.float64)
    x = np.asarray(sc.x)  # (12, 400, 2)
    want = j_pipeline(jnp.asarray(x), chunk_size=128)
    timer = StageTimer()
    got = t_pipeline(x, chunk_size=128, device="cpu", timer=timer)
    assert got.status == int(want.status) == 0
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-6)
    assert got.ba_log["n_solver_retries"] == int(want.ba_log["n_solver_retries"])
    assert set(timer.times) == {"perspective_self_calibration", "bundle_adjustment"}
    # at the noise floor of the scene (sigma = 0.005)
    assert float(got.error) < 1.2 * x.shape[0] * x.shape[1] * 2 * 0.005**2
