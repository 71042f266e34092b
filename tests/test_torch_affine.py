"""Parity of the port's affine pipeline with the JAX package, in float64
on the CPU, on the same numpy observations (the reference affine demo's
scene, 12 views x 200 points):

- ``observation_matrix``, ``metric_upgrade_from_subspace`` (from one
  subspace fed to both) and ``affine_self_calibration`` with
  ``canonical_signs`` for each camera model, to 1e-8; with the backend's
  own SVD signs, through ``aligned_rmse``;
- ``affine_self_calibration_full`` flags a non-finite scene of a batch and
  leaves the others as they are alone;
- ``affine_reconstruction`` for each model: final E to 1e-6, the same BA
  iterations. The port's pipeline pins the SVD signs (``canonical_signs``,
  the JAX point-sharded path's convention), so the JAX pipeline runs here
  with its calibration patched to the same convention;
- ``procrustes`` against JAX's and on the cases of
  ``tests/test_procrustes.py``;
- the ``affine`` subcommand of the command line.
"""

import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import affine as jaff
from mvrecon_tpu.models import pipelines as jpipe
from mvrecon_tpu.ops import procrustes as jpro
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.models import affine as taff
from mvrecon_tpu_torch.models.pipelines import affine_reconstruction as t_affine
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction as t_euclidean
from mvrecon_tpu_torch.ops import procrustes as tpro
from mvrecon_tpu_torch.runtime.profiling import StageTimer

MODELS = ["orthographic", "symmetric", "paraperspective"]



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def scene():
    sc = make_synthetic_scene(jax.random.key(123), n_images=12, dtype=jnp.float64)
    return np.array(sc.x), np.array(sc.X), np.ones(12)  # x (F, P, 2), X, f


def _close(got, want, tol=1e-8):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=tol, atol=tol * np.abs(w).max())


def test_observation_matrix_matches_jax(scene):
    x = scene[0]
    for got, want in zip(taff.observation_matrix(torch.from_numpy(x)),
                         jaff.observation_matrix(jnp.asarray(x))):
        _close(got, want, 1e-12)


@pytest.mark.parametrize("model", MODELS)
def test_metric_upgrade_from_subspace_matches_jax(scene, model):
    x, _, f = scene
    w, t = jaff.observation_matrix(jnp.asarray(x))
    u_ = np.linalg.svd(np.asarray(w), full_matrices=False)[0][:, :3]
    want = jax.jit(jaff.metric_upgrade_from_subspace, static_argnums=2)(
        jnp.asarray(u_), t, model, jnp.asarray(f))
    got = taff.metric_upgrade_from_subspace(torch.from_numpy(u_), torch.from_numpy(np.array(t)),
                                            model, torch.from_numpy(f))
    for g, w_ in zip(got, want):
        _close(g, w_)


@pytest.mark.parametrize("model", MODELS)
def test_self_calibration_matches_jax(scene, model):
    x, _, f = scene
    want = jaff.affine_self_calibration(jnp.asarray(x), model=model, f=jnp.asarray(f),
                                        canonical_signs=True)
    got = taff.affine_self_calibration(x, model=model, f=f, canonical_signs=True, device="cpu")
    for g, w in zip(got, want):
        _close(g, w)
    # the backend's own SVD signs: the same shape up to a similarity
    S_j = jaff.affine_self_calibration(jnp.asarray(x), model=model, f=jnp.asarray(f))[0]
    S_t = taff.affine_self_calibration(x, model=model, f=f, device="cpu")[0]
    assert float(tpro.aligned_rmse(S_t, torch.from_numpy(np.array(S_j)))) < 1e-8


def test_self_calibration_full_isolates_a_non_finite_scene(scene):
    x, _, f = scene
    xs = np.stack([x, x, x])
    xs[1, 4, 7, 0] = np.nan
    s, r, ok = taff.affine_self_calibration_full(xs, f=np.stack([f, f, f]), device="cpu")
    assert ok.tolist() == [True, False, True]
    assert not torch.isfinite(s[1]).any() and not torch.isfinite(r[1]).any()
    s1, r1 = taff.paraperspective_self_calibration(x, f, device="cpu")
    for i in (0, 2):
        _close(s[i], s1.numpy(), 1e-12)
        _close(r[i], r1.numpy(), 1e-12)


@pytest.fixture
def jax_canonical_signs(monkeypatch):
    """The JAX affine pipeline with its calibration on canonical signs."""
    monkeypatch.setattr(jpipe, "affine_self_calibration",
                        functools.partial(jaff.affine_self_calibration, canonical_signs=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("model", MODELS)
def test_affine_reconstruction_matches_jax(scene, model, jax_canonical_signs):
    x, _, f = scene
    fields = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=50)
    want = jpipe.affine_reconstruction(jnp.asarray(x), jnp.asarray(f), model=model,
                                       config=JLMConfig(**fields))
    timer = StageTimer()
    got = t_affine(x, f, model=model, config=LMConfig(**fields), device="cpu", timer=timer)
    assert got.status == int(want.status) == 0
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-6)
    assert set(timer.times) == {"affine_self_calibration", "bundle_adjustment"}
    floor = x.shape[0] * x.shape[1] * 2 * 0.005**2
    assert float(got.error) < 1.5 * floor


def test_umeyama_matches_jax():
    rng = np.random.default_rng(3)
    src, dst = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    for reflection in (False, True):
        want = jpro.umeyama(jnp.asarray(src), jnp.asarray(dst), allow_reflection=reflection)
        got = tpro.umeyama(torch.from_numpy(src), torch.from_numpy(dst),
                           allow_reflection=reflection)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)
        np.testing.assert_allclose(
            float(tpro.aligned_rmse(torch.from_numpy(src), torch.from_numpy(dst), reflection)),
            float(jpro.aligned_rmse(jnp.asarray(src), jnp.asarray(dst), reflection)), rtol=1e-12)


def test_umeyama_recovers_known_transform():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    s, t = 2.7, np.array([0.3, -1.2, 4.0])
    y = s * x @ q.T + t
    sim = tpro.umeyama(torch.from_numpy(x), torch.from_numpy(y), allow_reflection=False)
    np.testing.assert_allclose(float(sim.scale), s, rtol=1e-10)
    np.testing.assert_allclose(sim.R.numpy(), q, atol=1e-10)
    np.testing.assert_allclose(sim.t.numpy(), t, atol=1e-9)
    np.testing.assert_allclose(tpro.apply_similarity(sim, torch.from_numpy(x)).numpy(), y,
                               atol=1e-9)


def test_umeyama_handles_reflection():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(80, 3))
    y = x.copy()
    y[:, 2] *= -1  # mirror
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    assert float(tpro.aligned_rmse(x, y, allow_reflection=True)) < 1e-10
    assert float(tpro.aligned_rmse(x, y, allow_reflection=False)) > 0.1


def test_reconstruction_accuracy_metric_e2e():
    """The port's perspective pipeline aligns to the ground truth at the
    noise level (sigma = 0.005 at a 5-unit camera distance)."""
    sc = make_synthetic_scene(jax.random.key(123), n_images=10, dtype=jnp.float64)
    res = t_euclidean(np.asarray(sc.x), config=LMConfig(scale_factor=2.0, delta_tol=1e-8,
                                                         max_iter=50), device="cpu")
    assert float(tpro.aligned_rmse(res.X, torch.from_numpy(np.array(sc.X)))) < 0.05


def test_affine_cli_runs_on_cpu(capsys):
    from mvrecon_tpu_torch.__main__ import main

    assert main(["affine", "--model", "symmetric", "--n-images", "8", "--device", "cpu",
                 "--float64", "--max-iter", "30"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["command"] == "affine" and rec["model"] == "symmetric"
    assert rec["n_points"] == 200 and rec["n_views"] == 8 and rec["status"] == 0
    assert set(rec["stage_walls_s"]) == {"affine_self_calibration", "bundle_adjustment"}
    assert 0 < rec["ba_iterations"] <= 30 and rec["E_vs_noise_floor"] < 1.5
