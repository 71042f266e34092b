"""Robust losses (IRLS) in the port's three BA cores and the batched
pipeline, held against the JAX package on the CPU, on the same numpy
inputs: ``tests/test_robust_ba.py``'s outlier problem (the curved tube in
10 views, sigma = 0.003, 3 % of the observations moved by +-0.3 per
component, a start with X and t perturbed by 0.02 N(0, 1)).

- ``robust_weight`` of each loss in float64 to 1e-15, and the spellings
  ``resolve_robust`` takes;
- dense ``bundle_adjust`` per loss in float64: E to rtol 1e-9, X to 1e-8,
  the same iterations;
- the chunked core (chunk 64) for huber and cauchy against JAX's chunked
  core and the port's dense, in float64 to rtol 1e-9; its float32 fused
  path against JAX's fused path with the Pallas kernel interpreted: E to
  1e-4, iterations within one; the large pipeline against JAX's;
- the streamed core against JAX's, in float64 to rtol 1e-9;
- lanes: the batched robust pipeline against the per-scene runs (rtol
  1e-10) and against JAX's batched pipeline;
- Huber against plain with outliers (aligned RMSE below half), and a huge
  delta equal to plain least squares.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked as j_bac
from mvrecon_tpu.models.bundle_adjustment_streamed import bundle_adjust_streamed as j_bas
from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large as j_large
from mvrecon_tpu.ops import pallas_schur as jps
from mvrecon_tpu.parallel import batched as jbat
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import lm_config_from_fields, results_to_numpy
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked as t_bac
from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed as t_bas
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction_large as t_large
from mvrecon_tpu_torch.ops.procrustes import aligned_rmse
from mvrecon_tpu_torch.parallel import batched as tbat

AXIS = "x-up_z-forward"
KINDS = ("huber", "cauchy", "soft_l1", "arctan")
ROBUST = dict(scale_factor=2.0, delta_tol=1e-10, huber_delta=0.02)

_scene = jax.jit(make_synthetic_scene, static_argnames=("n_images", "n_slices", "dtype"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_outliers(x, rng):
    """x (..., 2) with 3 % of the entries moved by +-0.3 per component."""
    x = x.copy()
    mask = rng.uniform(size=x.shape[:-1]) < 0.03
    x[mask] += rng.choice([-0.3, 0.3], size=(mask.sum(), 2))
    return x


def _outlier_problem(dtype=np.float64):
    """(x (P, F, 2), X0, K, R, t0) as numpy, and the true X."""
    sc = _scene(jax.random.key(21), n_images=10, n_slices=10, noise=0.003, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x = _with_outliers(np.asarray(sc.x), rng).transpose(1, 0, 2)
    X0 = np.asarray(sc.X) + 0.02 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.02 * rng.standard_normal(sc.t.shape)
    prob = tuple(np.array(a, dtype=dtype, order="C")
                 for a in (x, X0, np.asarray(sc.K), np.asarray(sc.R), t0))
    return prob, np.asarray(sc.X)


def _jax(prob):
    return [jnp.asarray(a) for a in prob]


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("kind", KINDS)
def test_robust_weight_matches_jax(kind):
    mag = np.concatenate([[0.0, 1e-13, 0.02], np.random.default_rng(4).uniform(0, 0.5, 64)])
    want = np.asarray(jba.robust_weight(jnp.asarray(mag), 0.02, kind))
    got = tba.robust_weight(torch.from_numpy(mag), 0.02, kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_resolve_robust_spellings():
    for name in (None, "", "none", *KINDS):
        assert tba.resolve_robust(name) == jba.resolve_robust(name)
    assert tba.resolve_robust("none") is None and tba.resolve_robust("cauchy") == "cauchy"
    for bad in ("bogus", "Huber"):
        with pytest.raises(ValueError, match="unknown robust loss"):
            tba.resolve_robust(bad)
        with pytest.raises(ValueError, match="unknown robust loss"):
            tba.robust_weight(torch.ones(1), 0.02, bad)


# ---------------------------------------------------------------- the cores

def _port(fn, prob, fields, **kw):
    return results_to_numpy(fn(*prob, f0=1.0, axis=AXIS, config=lm_config_from_fields(fields),
                               device="cpu", **kw))


@pytest.mark.parametrize("kind", KINDS)
def test_dense_robust_matches_jax(kind):
    prob, _ = _outlier_problem()
    fields = dict(ROBUST, max_iter=25, robust=kind)
    want = jba.bundle_adjust(*_jax(prob), f0=1.0, axis=AXIS, config=JLMConfig(**fields))
    got = _port(tba.bundle_adjust, prob, fields)
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-9)
    np.testing.assert_allclose(got["X"], np.asarray(want.X), atol=1e-8)
    assert got["n_iter"] == int(want.n_iter)


@pytest.mark.parametrize("kind", ["huber", "cauchy"])
def test_chunked_robust_matches_jax_and_dense(kind):
    prob, _ = _outlier_problem()
    # two iterations: the second builds under weights taken anew; each retry
    # factors the fused build's 4608-wide padded system
    fields = dict(ROBUST, max_iter=2, robust=kind)
    want = j_bac(*_jax(prob), f0=1.0, axis=AXIS, config=JLMConfig(**fields), chunk_size=64)
    got = _port(t_bac, prob, fields, chunk_size=64)
    dense = _port(tba.bundle_adjust, prob, fields)
    for ref in (float(want.error), float(dense["error"])):
        np.testing.assert_allclose(float(got["error"]), ref, rtol=1e-9)
    assert got["n_iter"] == int(want.n_iter) == dense["n_iter"]
    assert got["log"]["n_solver_retries"] == int(want.log["n_solver_retries"])
    np.testing.assert_allclose(got["X"], np.asarray(want.X), atol=1e-8)


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """JAX's fused chunked core with the interpreted kernel. ``_MODE`` is
    read at trace time and is not part of the jit cache key, so the
    caches are cleared on both sides of the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jps, "_MODE", "interpret")
    yield
    jax.clear_caches()


def test_fused_float32_robust_matches_jax_fused(jax_fused_interpret):
    """float32: the weighted bf16 Y through both fused builds (the port's
    K2 plain version, JAX's kernel interpreted)."""
    prob, _ = _outlier_problem(np.float32)
    fields = dict(ROBUST, delta_tol=0.0, max_iter=2, robust="huber")
    want = j_bac(*_jax(prob), f0=1.0, axis=AXIS, config=JLMConfig(**fields), chunk_size=64)
    got = _port(t_bac, prob, fields, chunk_size=64)
    assert got["error"].dtype == np.float32
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-4)
    assert abs(got["n_iter"] - int(want.n_iter)) <= 1


@pytest.mark.parametrize("kind,chunk,masked", [("huber", 48, True), ("soft_l1", 50, False)],
                         ids=["huber-ragged-masked", "soft_l1-aligned"])
def test_streamed_robust_matches_jax(kind, chunk, masked):
    prob, _ = _outlier_problem()
    vis = None
    if masked:
        vis = (np.random.default_rng(1).uniform(size=prob[0].shape[:2]) > 0.1).astype(np.float64)
    fields = dict(ROBUST, max_iter=6, robust=kind)
    want = j_bas(*prob, f0=1.0, visibility=vis, axis=AXIS, config=JLMConfig(**fields),
                 chunk_size=chunk)
    got = _port(t_bas, prob, fields, visibility=vis, chunk_size=chunk)
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-9)
    assert got["n_iter"] == int(want.n_iter)
    assert got["log"]["n_solver_retries"] == int(want.log["n_solver_retries"])
    np.testing.assert_allclose(got["X"], np.asarray(want.X), atol=1e-8)


# ---------------------------------------------------------------- lanes

@pytest.fixture(scope="module")
def x_batch():
    """Three 6-view scenes of 200 points (F, P, 2), sigma = 0.005. The
    perspective calibration is not robust to gross outliers, so the loss
    scale is the noise level instead: the weights fall below 1 on about
    half of the observations."""
    return np.stack([np.asarray(_scene(jax.random.key(s), n_images=6, n_slices=10,
                                       dtype=jnp.float64).x) for s in (123, 7, 99)])


def test_batched_robust_lanes_equal_single_scenes_and_jax(x_batch):
    # the weighted E moves with the weights: at 1e-5 the lanes stop apart
    fields = dict(scale_factor=2.0, delta_tol=1e-5, max_iter=15, robust="cauchy",
                  huber_delta=0.005)
    got = tbat.batched_euclidean_reconstruction(x_batch, config=LMConfig(**fields), device="cpu")
    assert len(set(got.n_iter.tolist())) > 1  # the lanes stop apart
    for i in range(x_batch.shape[0]):
        one = euclidean_reconstruction(x_batch[i], config=LMConfig(**fields), device="cpu")
        assert got.status[i].item() == one.status == 0
        assert got.n_iter[i].item() == one.n_iter
        np.testing.assert_allclose(got.error[i].item(), float(one.error), rtol=1e-10)
    want = jbat.batched_euclidean_reconstruction(jnp.asarray(x_batch),
                                                 config=JLMConfig(**fields))
    assert got.status.tolist() == np.asarray(want.status).tolist()
    assert got.n_iter.tolist() == np.asarray(want.n_iter).tolist()
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error), rtol=1e-6)


def test_large_pipeline_robust_matches_jax(x_batch):
    """A robust config passes through ``euclidean_reconstruction_large`` to
    the fused chunked core unchanged (the camera bootstrap keeps its own
    plain config)."""
    fields = dict(scale_factor=4.0, delta_tol=0.0, max_iter=2, accept_divisor=1.0,
                  init_damping=3e-3, damping="nielsen", robust="huber", huber_delta=0.005)
    want = j_large(jnp.asarray(x_batch[0]), config=JLMConfig(**fields), chunk_size=128)
    got = t_large(x_batch[0], config=LMConfig(**fields), chunk_size=128, device="cpu")
    assert got.status == int(want.status) == 0
    assert got.n_iter == int(want.n_iter)
    assert got.ba_log["n_solver_retries"] == int(want.ba_log["n_solver_retries"])
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-6)


# ---------------------------------------------------------------- behaviour

def test_huber_beats_plain_with_outliers():
    prob, X_true = _outlier_problem()
    fields = dict(scale_factor=2.0, delta_tol=1e-10, max_iter=25)
    plain = tba.bundle_adjust(*prob, axis=AXIS, config=LMConfig(**fields), device="cpu")
    robust = tba.bundle_adjust(*prob, axis=AXIS, device="cpu",
                               config=LMConfig(**fields, robust="huber", huber_delta=0.02))
    truth = torch.from_numpy(X_true)
    err_plain, err_robust = (float(aligned_rmse(r.X, truth)) for r in (plain, robust))
    assert np.isfinite(err_robust)
    assert err_robust < 0.5 * err_plain
    assert err_robust < 0.02


@pytest.mark.parametrize("core", ["dense", "streamed"])
def test_huge_delta_equals_plain(core):
    """With delta far above every residual the Huber weights are 1 and the
    run is plain least squares."""
    prob, _ = _outlier_problem()
    fields = dict(scale_factor=2.0, delta_tol=1e-10, max_iter=8)
    run = {"dense": functools.partial(_port, tba.bundle_adjust),
           "streamed": functools.partial(_port, t_bas, chunk_size=64)}[core]
    plain = run(prob, fields)
    robust = run(prob, dict(fields, robust="huber", huber_delta=1e3))
    np.testing.assert_allclose(robust["X"], plain["X"], atol=1e-6)
    np.testing.assert_allclose(float(robust["error"]), float(plain["error"]), rtol=1e-9)
    assert robust["n_iter"] == plain["n_iter"]
