"""Parity of the port's chunked bundle adjustment with the JAX package on
the CPU, on the same numpy starting state.

- float64: the port's fused build (float64 Y and accumulator, the
  non-fused algebra permuted) against JAX's non-fused chunked core, its
  CPU default: final E to 1e-8, the same iterations and solver retries.
- float32: against JAX's fused core with its Pallas kernel in interpret
  mode, both with bf16 Y: final E to 1e-3, iterations within one.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked as j_bac
from mvrecon_tpu.ops import pallas_schur as jps
from mvrecon_tpu_torch.interop import lm_config_from_fields, results_to_numpy
from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked as t_bac


def _problem(nf, n_slices, dtype, seed=5):
    """Noisy observations (P, F, 2) and a perturbed start, as numpy."""
    sc = make_synthetic_scene(jax.random.key(seed), n_images=nf, n_slices=n_slices,
                              n_angles=20, dtype=jnp.float64, noise=0.003)
    rng = np.random.default_rng(seed)
    X0 = np.asarray(sc.X) + 0.02 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.02 * rng.standard_normal(sc.t.shape)
    arrs = (np.asarray(sc.x).transpose(1, 0, 2), X0, np.asarray(sc.K), np.asarray(sc.R), t0)
    return tuple(np.ascontiguousarray(a, dtype=dtype) for a in arrs)


def _run_both(prob, cfg, chunk, visibility=None):
    jres = j_bac(*(jnp.asarray(a) for a in prob), f0=1.0,
                 visibility=None if visibility is None else jnp.asarray(visibility),
                 axis="x-up_z-forward", config=cfg, chunk_size=chunk)
    tres = t_bac(*prob, f0=1.0, visibility=visibility, axis="x-up_z-forward",
                 config=lm_config_from_fields(dataclasses.asdict(cfg)), chunk_size=chunk,
                 device="cpu")
    return jres, results_to_numpy(tres)


F64_CASES = {
    # P = 100 points over chunks of 32: a ragged last chunk of 4
    "reference-ragged": (dict(scale_factor=2.0, delta_tol=1e-8, max_iter=6), 32, False),
    "nielsen-aligned": (dict(scale_factor=4.0, delta_tol=0.0, max_iter=6, accept_divisor=1.0,
                             init_damping=3e-3, damping="nielsen"), 50, False),
    "reference-masked": (dict(scale_factor=2.0, delta_tol=1e-8, max_iter=6), 40, True),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_chunked_ba_float64_matches_jax(case):
    fields, chunk, masked = F64_CASES[case]
    prob = _problem(6, 5, np.float64)
    vis = None
    if masked:
        vis = (np.random.default_rng(1).uniform(size=prob[0].shape[:2]) > 0.15).astype(np.float64)
    jres, tres = _run_both(prob, JLMConfig(**fields), chunk, vis)
    np.testing.assert_allclose(float(tres["error"]), float(jres.error), rtol=1e-8)
    assert tres["n_iter"] == int(jres.n_iter)
    assert tres["log"]["n_solver_retries"] == int(jres.log["n_solver_retries"])
    np.testing.assert_allclose(tres["X"], np.asarray(jres.X), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tres["K"], np.asarray(jres.K), rtol=1e-6, atol=1e-8)


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """JAX's fused chunked core with the interpreted kernel. ``_MODE`` is
    read at trace time and is not part of the jit cache key, so the
    caches are cleared on both sides of the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jps, "_MODE", "interpret")
    yield
    jax.clear_caches()


@pytest.mark.parametrize("damping", ["reference", "nielsen"])
def test_chunked_ba_float32_matches_jax_fused(jax_fused_interpret, damping):
    prob = _problem(7, 4, np.float32)  # 80 points, chunks of 32 (ragged 16)
    fields = dict(scale_factor=2.0, delta_tol=0.0, max_iter=5)
    if damping == "nielsen":
        fields.update(scale_factor=4.0, accept_divisor=1.0, init_damping=3e-3, damping="nielsen")
    jres, tres = _run_both(prob, JLMConfig(**fields), 32)
    assert tres["error"].dtype == np.float32
    np.testing.assert_allclose(float(tres["error"]), float(jres.error), rtol=1e-3)
    assert abs(tres["n_iter"] - int(jres.n_iter)) <= 1
