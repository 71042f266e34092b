"""Lens distortion (BAL radial and OPENCV) through the port's chunked and
streamed BA cores and the covariance, held against the JAX package on the
CPU on the same numpy inputs: the curved tube in 6 views x 60 points,
rendered through each model with JAX's own terms, chunks of 16 (a padded
tail of 12).

- the fused build (radial) in float64 against JAX's chunked core (which
  takes its non-fused build on the CPU) and the port's dense core, with a
  refit round under Huber: E rtol 1e-8, X atol 1e-7, the same iterations,
  k atol 1e-8;
- the fused build in float32 with a given radial model against JAX's
  fused path with the Pallas kernel interpreted, one iteration: E rtol
  1e-4;
- the non-fused build (OPENCV, K1's plain version here) against JAX's:
  one build's reduced system A, b and E against JAX's ``_build_system`` to
  1e-10 of the largest entry, then the core as above, the model given
  under Huber and refit from zero;
- ``fit_distortion_chunked`` with a padded tail chunk against JAX's and the
  dense refit (atol 1e-12);
- the streamed core and its refit, radial and OPENCV, with and without a
  mask, under Huber too, against JAX's streamed core;
- ``ba_covariance``, ``ba_covariance_chunked`` and ``ba_covariance_streamed``
  with ``distortion=``, plain and Huber, against JAX's ``ba_covariance``
  (float64, rtol 1e-8).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu.models import bundle_adjustment_chunked as jbc
from mvrecon_tpu.models import covariance as jcov
from mvrecon_tpu.models.bundle_adjustment_streamed import bundle_adjust_streamed as j_bas
from mvrecon_tpu.ops import pallas_schur as jps
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import (
    ba_state_from_numpy,
    distortion_from_numpy,
    lm_config_from_fields,
    results_to_numpy,
)
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models import bundle_adjustment_chunked as tbc
from mvrecon_tpu_torch.models import covariance as tcov
from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed as t_bas

AXIS = "x-up_z-forward"
NF = 6
CHUNK = 16  # 60 points: three full chunks and a tail of 12 (padded)
TRUTH = {
    "radial": np.array([-0.3, 0.05]),
    "opencv": np.array([-0.28, 0.035, 0.018, -0.012]),
}
HUBER = dict(robust="huber", huber_delta=0.004)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(model, dtype=np.float64, seed=0):
    """((x (P, F, 2), X0, K, R, t0) as numpy, the true distortion (F, n)):
    the tube rendered through a per-camera model around ``TRUTH[model]``,
    noise 0.002, outliers on 3 % of the observations (+-0.05), X and t
    perturbed by 0.01 N(0, 1)."""
    sc = make_synthetic_scene(jax.random.key(seed), n_images=NF, n_slices=3, n_angles=20,
                              dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    dist = TRUTH[model] * (1.0 + 0.1 * rng.standard_normal((NF, TRUTH[model].size)))
    st = jba.BAState(X=sc.X, f=sc.K[:, 0, 0], u=sc.K[:, :2, 2], t=sc.t, R=sc.R)
    _, p, q, r = jba.calc_pqr(st.X, jba.build_K(st.f, st.u, 1.0), st.R, st.t)
    g1, g2, _, d, _ = jba._distortion_terms(st, p, q, r, 1.0, jnp.asarray(dist))
    x1, x2 = d * g1 + st.u[:, 0][None], d * g2 + st.u[:, 1][None]
    if model == "opencv":
        t1, t2, _, _, _ = jba._tangential_terms(st, g1, g2, 1.0, jnp.asarray(dist))
        x1, x2 = x1 + t1, x2 + t2
    x = np.asarray(jnp.stack([x1, x2], -1)) + 0.002 * rng.standard_normal((60, NF, 2))
    out = rng.uniform(size=(60, NF)) < 0.03
    x[out] += rng.choice([-0.05, 0.05], size=(out.sum(), 2))
    X0 = np.asarray(sc.X) + 0.01 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.01 * rng.standard_normal(sc.t.shape)
    prob = tuple(np.array(a, dtype=dtype, order="C")
                 for a in (x, X0, np.asarray(sc.K), np.asarray(sc.R), t0))
    return prob, dist


def _mask(shape, seed=3):
    return (np.random.default_rng(seed).uniform(size=shape) > 0.15).astype(np.float64)


def _fields(model, rounds, robust, **kw):
    fields = dict(scale_factor=2.0, delta_tol=1e-12, max_iter=3, distortion_model=model,
                  distortion_rounds=rounds, distortion_shared=rounds == 1)
    fields.update(kw)
    if robust:
        fields.update(HUBER)
    return fields


def _check(got, want, model, n_iter_tol=0, e_rtol=1e-8):
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=e_rtol)
    assert abs(got["n_iter"] - int(want.n_iter)) <= n_iter_tol
    if n_iter_tol == 0:
        np.testing.assert_allclose(got["X"], np.asarray(want.X), atol=1e-7)
        np.testing.assert_allclose(got["distortion"], np.asarray(want.distortion), atol=1e-8)
    assert got["distortion"].shape == (NF, TRUTH[model].size)


def _port(fn, prob, fields, **kw):
    return results_to_numpy(fn(*prob, f0=1.0, axis=AXIS, config=lm_config_from_fields(fields),
                               device="cpu", **kw))


# ------------------------------------------------------------- chunked

CHUNKED_CASES = {
    # (model, rounds, robust, fixed): the fused build for radial (given k in
    # the float32 test below), the non-fused one for OPENCV
    "radial-rounds-huber": ("radial", 1, True, False),
    "opencv-fixed-huber": ("opencv", 0, True, True),
    "opencv-rounds": ("opencv", 2, False, False),
}


@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_chunked_matches_jax_and_dense(case):
    model, rounds, robust, fixed = CHUNKED_CASES[case]
    prob, dist = _problem(model)
    # the port's float64 fused build pads 6 views to a 4608-wide system,
    # whose Cholesky dominates a retry: fewer iterations there
    fields = _fields(model, rounds, robust, max_iter=1 if model == "radial" else 3)
    d = dist if fixed else None
    want = jbc.bundle_adjust_chunked(*map(jnp.asarray, prob), f0=1.0, axis=AXIS,
                                     config=JLMConfig(**fields), chunk_size=CHUNK,
                                     distortion=None if d is None else jnp.asarray(d))
    got = _port(tbc.bundle_adjust_chunked, prob, fields, chunk_size=CHUNK, distortion=d)
    _check(got, want, model)
    assert got["log"]["n_solver_retries"] == int(want.log["n_solver_retries"])
    assert got["log"]["n_solver_retries_total"] >= got["log"]["n_solver_retries"]
    dense = _port(tba.bundle_adjust, prob, fields, distortion=d)
    np.testing.assert_allclose(float(got["error"]), float(dense["error"]), rtol=1e-8)
    np.testing.assert_allclose(got["distortion"], dense["distortion"], atol=1e-8)
    assert got["n_iter"] == dense["n_iter"]


@pytest.fixture
def jax_fused_interpret(monkeypatch):
    """JAX's fused chunked core with the interpreted kernel. ``_MODE`` is
    read at trace time and is not part of the jit cache key, so the
    caches are cleared on both sides of the patch."""
    jax.clear_caches()
    monkeypatch.setattr(jps, "_MODE", "interpret")
    yield
    jax.clear_caches()


def test_fused_float32_radial_matches_jax_fused(jax_fused_interpret):
    """float32: the radial chain through both fused builds (the port's K2
    plain version, JAX's kernel interpreted), under Huber, one iteration.
    Past that the two bf16 builds part: a bf16 Y element that rounds the
    other way moves the step by 1e-3, and under Huber the weights then move
    the weighted E by up to 1 %. The float32 refit is
    ``tests/test_torch_distortion.py``'s."""
    prob, dist = _problem("radial", dtype=np.float32)
    fields = _fields("radial", 0, True, max_iter=1, delta_tol=0.0)
    d = dist.astype(np.float32)
    # one chunk: the interpreted kernel costs seconds a launch
    want = jbc.bundle_adjust_chunked(*map(jnp.asarray, prob), f0=1.0, axis=AXIS,
                                     config=JLMConfig(**fields), chunk_size=64,
                                     distortion=jnp.asarray(d))
    got = _port(tbc.bundle_adjust_chunked, prob, fields, chunk_size=64, distortion=d)
    assert got["error"].dtype == np.float32
    _check(got, want, "radial", n_iter_tol=1, e_rtol=1e-4)


def _chunks(a, n):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in np.split(a, n)]


@pytest.mark.parametrize("robust", [False, True], ids=["plain", "huber"])
def test_non_fused_build_matches_jax(robust):
    """One non-fused build of the OPENCV model, K1's deferred-mirror sum
    over four chunks (the last one padded with masked rows): the damped,
    gauge-projected A, b, E, diag(G) and d_F against JAX's
    ``_build_system``."""
    prob, dist = _problem("opencv")
    x, X0, K, R, t0 = prob
    vis = _mask(x.shape[:2])
    pad = 4
    x = np.concatenate([x, np.zeros((pad, NF, 2))])
    vis = np.concatenate([vis, np.zeros((pad, NF))])
    Xn, Rn, tn, _ = jba.normalize_gauge(jnp.asarray(X0), jnp.asarray(R), jnp.asarray(t0), AXIS)
    f, u = jba.intrinsics_from_K(jnp.asarray(K), 1.0)
    X = np.concatenate([np.asarray(Xn), np.broadcast_to(np.asarray(Xn).mean(0), (pad, 3))])
    fields = [np.zeros((0, 3))] + [np.asarray(a) for a in (f, u, tn, Rn)]
    jcam = jba.BAState(*(jnp.asarray(a) for a in fields))
    tcam = ba_state_from_numpy(*fields, "cpu", torch.float64)
    free = np.array(jba.gauge_mask(NF, AXIS, jnp.float64))
    n_ch = X.shape[0] // CHUNK
    hd = HUBER["huber_delta"] if robust else None
    c = 3e-3
    want = jbc._build_system(jcam, *(jnp.asarray(a.reshape((n_ch, CHUNK) + a.shape[1:]))
                                     for a in (X, x, vis)),
                             jnp.asarray(free), 1.0, jnp.float64(c), None, hd,
                             jnp.asarray(dist), "opencv")
    got = tbc._build_system(tcam, _chunks(X, n_ch), _chunks(x, n_ch), _chunks(vis, n_ch),
                            torch.from_numpy(free), 1.0, c, hd, "huber",
                            torch.from_numpy(dist), "opencv")
    a_g, b_g, e_g, (dg_g, df_g) = got
    a_w, b_w, e_w, (dg_w, df_w) = want
    for g, w in ((a_g, a_w), (b_g, b_w), (dg_g, dg_w), (df_g, df_w)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-10 * np.abs(w).max())
    np.testing.assert_allclose(float(e_g), float(e_w), rtol=1e-12)


@pytest.mark.parametrize("model", list(TRUTH))
@pytest.mark.parametrize("robust", [False, True], ids=["plain", "huber"])
def test_fit_distortion_chunked_matches_jax_and_dense(model, robust):
    """The refit summed over chunks with a padded tail equals JAX's chunked
    refit and, without a loss, the dense one."""
    prob, dist = _problem(model)
    x, X0, K, R, _ = prob
    vis = _mask(x.shape[:2])
    state = jba.BAState(X=jnp.asarray(X0), f=jnp.asarray(K[:, 0, 0]), u=jnp.asarray(K[:, :2, 2]),
                        t=jnp.asarray(prob[4]), R=jnp.asarray(R))
    tstate = ba_state_from_numpy(*(np.asarray(a) for a in state), "cpu", torch.float64)
    hd = HUBER["huber_delta"] if robust else None
    cur = 0.5 * dist  # the current model the Huber weights are taken from
    want = jbc.fit_distortion_chunked(state, jnp.asarray(x), jnp.asarray(vis), 1.0, CHUNK,
                                      huber_delta=hd, dist=jnp.asarray(cur), model=model)
    got = tbc.fit_distortion_chunked(tstate, torch.from_numpy(x), torch.from_numpy(vis), 1.0,
                                     CHUNK, huber_delta=hd, dist=torch.from_numpy(cur))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    if not robust:
        dense = tba.fit_distortion(tstate, torch.from_numpy(x), torch.from_numpy(vis), 1.0,
                                   model=model)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-12)


# ------------------------------------------------------------- streamed

STREAMED_CASES = {
    # (model, rounds, robust, masked, fixed)
    "radial-rounds": ("radial", 1, False, False, False),
    "radial-fixed-huber-masked": ("radial", 0, True, True, True),
    "opencv-rounds-huber-masked": ("opencv", 1, True, True, False),
    "opencv-fixed": ("opencv", 0, False, False, True),
}


@pytest.mark.parametrize("case", list(STREAMED_CASES))
def test_streamed_matches_jax(case):
    model, rounds, robust, masked, fixed = STREAMED_CASES[case]
    prob, dist = _problem(model)
    vis = _mask(prob[0].shape[:2]) if masked else None
    fields = _fields(model, rounds, robust, max_iter=4)
    d = dist if fixed else None
    want = j_bas(*prob, f0=1.0, visibility=vis, axis=AXIS, config=JLMConfig(**fields),
                 chunk_size=CHUNK, distortion=d)
    got = _port(t_bas, prob, fields, visibility=vis, chunk_size=CHUNK, distortion=d)
    _check(got, want, model)
    assert got["log"]["n_solver_retries"] == int(want.log["n_solver_retries"])


# ------------------------------------------------------------ covariance

def _solved(model):
    """A converged float64 solution of the distorted problem, as numpy:
    (x, X, K, R, t, distortion)."""
    prob, dist = _problem(model)
    res = tba.bundle_adjust(*prob, axis=AXIS, distortion=dist, device="cpu",
                            config=LMConfig(scale_factor=2.0, delta_tol=1e-12, max_iter=15))
    return (prob[0],) + tuple(res[i].numpy() for i in range(4)) + (dist,)


COVARIANCES = {
    "dense": lambda *a, **kw: tcov.ba_covariance(*a, **kw),
    "chunked": lambda *a, **kw: tcov.ba_covariance_chunked(*a, chunk_size=CHUNK, **kw),
    "streamed": lambda *a, **kw: tcov.ba_covariance_streamed(*a, chunk_size=CHUNK,
                                                              dtype=torch.float64, **kw),
}


@pytest.mark.parametrize("model", list(TRUTH))
@pytest.mark.parametrize("robust", [False, True], ids=["plain", "huber"])
def test_covariance_with_distortion_matches_jax(model, robust):
    x, X, K, R, t, dist = _solved(model)
    vis = _mask(x.shape[:2])
    fields = dict(HUBER) if robust else {}
    want = jcov.ba_covariance(*map(jnp.asarray, (x, X, K, R, t)), f0=1.0,
                              visibility=jnp.asarray(vis), axis=AXIS,
                              config=JLMConfig(**fields), distortion=jnp.asarray(dist))
    for name, fn in COVARIANCES.items():
        got = fn(x, X, K, R, t, f0=1.0, visibility=vis, axis=AXIS,
                 config=LMConfig(**fields), distortion=dist, device="cpu")
        for k in ("point_cov", "camera_cov"):
            w = np.asarray(getattr(want, k))
            np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=0,
                                       atol=1e-8 * np.abs(w).max(), err_msg=f"{name} {k}")
        np.testing.assert_allclose(float(got.sigma2), float(want.sigma2), rtol=1e-8)
        np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-10)
        assert int(got.n_obs) == int(want.n_obs)


def test_covariance_distortion_as_tensor_and_lanes():
    """A tensor distortion gives what numpy gives; with lanes it raises."""
    x, X, K, R, t, dist = _solved("radial")
    want = tcov.ba_covariance(x, X, K, R, t, axis=AXIS, distortion=dist, device="cpu")
    got = tcov.ba_covariance(x, X, K, R, t, axis=AXIS, device="cpu",
                             distortion=distortion_from_numpy(dist, torch.from_numpy(x)))
    assert torch.equal(got.camera_cov, want.camera_cov)
    lanes = [np.stack([a, a]) for a in (x, X, K, R, t)]
    with pytest.raises(ValueError, match="one problem"):
        tcov.ba_covariance(*lanes, axis=AXIS, distortion=dist, device="cpu")
