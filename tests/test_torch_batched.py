"""Scene batching in the port (``parallel/batched.py``), held against its
own single-scene pipelines and against the JAX package's batched
functions, in float64 on the CPU, on the same numpy observations (three
6-view scenes and four 12-view scenes of 200 points, seeds as in
``tests/test_parallel.py``):

- lanes against single scenes: ``batched_euclidean_reconstruction`` with
  ``delta_tol=1e-8``, so that the lanes stop at different iterations,
  equals the port's ``euclidean_reconstruction`` on each scene alone: the
  same status and BA iterations, E to rtol 1e-10;
- port against JAX: ``batched_euclidean_reconstruction`` and
  ``batched_affine_reconstruction``, with and without ``scene_chunk``:
  statuses, iterations, E to 1e-6 (the affine calibration on canonical
  signs on both sides, as the port's pipeline pins them);
- ``batched_euclidean_to_convergence`` against JAX's, with a budget small
  enough that continuation phases run;
- fault isolation: one all-NaN scene of three ends non-finite with status
  2, and the others equal their clean run;
- ``results_to_numpy`` on a batched result, and the ``batch`` subcommand.

Each JAX batched function is one ``jit`` over the whole pipeline, so each
is called once per module, through a fixture.
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
from mvrecon_tpu.parallel import batched as jbat
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import results_to_numpy
from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction
from mvrecon_tpu_torch.parallel import batched as tbat

EUCLID = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=15)
AFFINE = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=20)
FLOOR6 = 200 * 6 * 2 * 0.005**2


_scene = jax.jit(make_synthetic_scene, static_argnames=("n_images", "dtype"))


def _scenes(n_images, seeds):
    return np.stack([np.array(_scene(jax.random.key(s), n_images=n_images,
                                     dtype=jnp.float64).x) for s in seeds])



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def x6():
    return _scenes(6, (123, 7, 99))  # (3, 6, 200, 2)


@pytest.fixture(scope="module")
def x12():
    return _scenes(12, (123, 7, 11, 42))  # (4, 12, 200, 2)


@pytest.fixture(scope="module")
def port_euclid(x6):
    return tbat.batched_euclidean_reconstruction(x6, config=LMConfig(**EUCLID), device="cpu")


@pytest.fixture(scope="module")
def jax_euclid(x6):
    return jbat.batched_euclidean_reconstruction(jnp.asarray(x6), config=JLMConfig(**EUCLID))


@pytest.fixture(scope="module")
def jax_affine(x12):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "affine_self_calibration",
                   functools.partial(jaff.affine_self_calibration, canonical_signs=True))
        jax.clear_caches()
        res = jbat.batched_affine_reconstruction(jnp.asarray(x12), jnp.ones((4, 12)),
                                                 config=JLMConfig(**AFFINE))
        jax.block_until_ready(res)
    jax.clear_caches()
    return res


def _same(got, want, rtol=1e-6):
    assert got.status.tolist() == np.asarray(want.status).tolist()
    assert got.n_iter.tolist() == np.asarray(want.n_iter).tolist()
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error), rtol=rtol)


def test_lanes_equal_single_scenes(x6, port_euclid):
    assert len(set(port_euclid.n_iter.tolist())) > 1  # the lanes stop apart
    for i in range(x6.shape[0]):
        one = euclidean_reconstruction(x6[i], config=LMConfig(**EUCLID), device="cpu")
        assert port_euclid.status[i].item() == one.status == 0
        assert port_euclid.n_iter[i].item() == one.n_iter
        np.testing.assert_allclose(port_euclid.error[i].item(), float(one.error), rtol=1e-10)
        np.testing.assert_allclose(port_euclid.X[i].numpy(), one.X.numpy(), rtol=1e-8,
                                   atol=1e-10)


def test_batched_euclidean_matches_jax(x6, port_euclid, jax_euclid):
    assert port_euclid.X.shape == (3, 200, 3)
    _same(port_euclid, jax_euclid)
    assert (port_euclid.error.numpy() < 5 * FLOOR6).all()
    chunked = tbat.batched_euclidean_reconstruction(x6, config=LMConfig(**EUCLID),
                                                    scene_chunk=2, device="cpu")
    _same(chunked, jax_euclid)
    assert chunked.ba_log["c"].shape == (3,)


@pytest.mark.parametrize("scene_chunk", [None, 3])
def test_batched_affine_matches_jax(x12, jax_affine, scene_chunk):
    got = tbat.batched_affine_reconstruction(x12, np.ones((4, 12)), config=LMConfig(**AFFINE),
                                             scene_chunk=scene_chunk, device="cpu")
    assert got.X.shape == (4, 200, 3) and got.status.tolist() == [0, 0, 0, 0]
    _same(got, jax_affine)


def test_to_convergence_matches_jax(x6):
    fields = dict(scale_factor=2.0, delta_tol=1e-3, max_iter=3)
    kw = dict(eig_method="lowrank", continuation_budget=4, max_phases=3)
    want = jbat.batched_euclidean_to_convergence(jnp.asarray(x6), config=JLMConfig(**fields),
                                                 **kw)
    got = tbat.batched_euclidean_to_convergence(x6, config=LMConfig(**fields), device="cpu",
                                                **kw)
    assert got.ba_log["phases"] >= 1 and got.n_iter.max().item() > fields["max_iter"]
    _same(got, want)
    with pytest.raises(ValueError, match="delta_tol"):
        tbat.batched_euclidean_to_convergence(x6, config=LMConfig(delta_tol=0.0), device="cpu")


def test_fault_isolation(x6, port_euclid):
    """One poisoned scene in the batch ends non-finite and flags itself;
    the others run exactly as without it."""
    x = x6.copy()
    x[1] = np.nan
    res = tbat.batched_euclidean_reconstruction(x, config=LMConfig(**EUCLID), device="cpu")
    err = res.error.numpy()
    assert res.status.tolist() == [0, 2, 0]
    assert not np.isfinite(err[1])
    for i in (0, 2):
        assert err[i] < 5 * FLOOR6
        assert res.n_iter[i].item() == port_euclid.n_iter[i].item()
        np.testing.assert_allclose(err[i], port_euclid.error[i].item(), rtol=1e-10)


def test_results_to_numpy_takes_batched_results(port_euclid):
    out = results_to_numpy(port_euclid)
    assert out["X"].shape == (3, 200, 3) and out["status"].shape == (3,)
    assert out["n_iter"].dtype == np.int64 and out["ba_log"]["c"].shape == (3,)
    assert isinstance(out["ba_log"]["n_solver_retries"], int)


def test_batch_cli_runs_on_cpu(capsys):
    from mvrecon_tpu_torch.__main__ import main

    assert main(["batch", "--scenes", "3", "--n-images", "6", "--scene-chunk", "2",
                 "--eig-method", "lowrank", "--max-iter", "10", "--device", "cpu",
                 "--float64"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["command"] == "batch" and rec["scenes"] == 3 and rec["scene_chunk"] == 2
    assert rec["statuses"] == [0, 0, 0] and len(rec["reprojection_errors"]) == 3
    assert all(0 < n <= 10 for n in rec["ba_n_iters"])
    assert rec["E_vs_noise_floor"] < 5
