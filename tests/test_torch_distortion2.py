"""Lens distortion II (fisheye, full OPENCV, FOV, thin prism) in the port's
dense core, held against the JAX package on the CPU on the same numpy
inputs: the curved tube in 6 views, rendered through each model with
JAX's own ``_distorted_residual``, per-camera truths around the centres of
JAX's ``tests/test_distortion.py`` scenes.

- the scales (``_fisheye_scale``, ``_rational_scale``, ``_fov_scale``,
  ``_fov_domega``) on a grid of s through 0 and the Taylor switch, and the
  FOV pinhole limit, to 1e-12;
- ``_distortion_terms``, ``_thin_prism_terms``, ``_tangential_terms`` with
  full OPENCV's column offset, ``_apply_distortion_chain`` and
  ``_distorted_residual`` in float64 to 1e-12, with and without a mask;
  ``_compute_derivs`` to 1e-10;
- autograd and ``jacrev`` as the oracle, and finite gradients at s = 0 for
  fisheye, FOV and thin prism (the double-where guards);
- ``fit_distortion`` per camera and shared against JAX (1e-8 of the
  largest parameter, ``_close_k``), exact
  recovery at the true geometry (full OPENCV as a function, as JAX's own
  test holds it), degenerate cameras as in JAX;
- dense ``bundle_adjust`` with the model fixed and with one refit round, in
  float64 (E rtol 1e-8, X atol 1e-7, k atol 1e-8, the same iterations) and
  float32 (E rtol 1e-3, iterations within one);
- ``distort_points`` and ``undistort_points`` against JAX for every family,
  and the round trip to 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu_torch.interop import ba_state_from_numpy, lm_config_from_fields, results_to_numpy
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.ops.rotations import rodrigues

AXIS = "x-up_z-forward"
NF = 6
# (centre, spread) per parameter: the truths of tests/test_distortion.py's
# _fisheye_scene, _full_opencv_scene, _fov_scene and _thin_prism_scene
CENTRES = {
    "fisheye": ([-0.08, 0.02, 0.008, -0.004], [0.03, 0.01, 0.004, 0.002]),
    "full_opencv": ([-0.30, 0.05, -0.01, -0.12, 0.02, 0.005, 0.015, -0.01],
                    [0.04, 0.02, 0.005, 0.03, 0.01, 0.002, 0.008, 0.006]),
    "fov": ([0.9], [0.15]),
    "thin_prism": ([-0.06, 0.015, -0.004, 0.002, 0.012, -0.009, 0.006, -0.005],
                   [0.02, 0.006, 0.002, 0.001, 0.006, 0.005, 0.003, 0.003]),
}
MODELS = list(CENTRES)
ALL_MODELS = ("radial", "opencv") + tuple(MODELS)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _truth(model, rng):
    centre, spread = (np.asarray(v) for v in CENTRES[model])
    return centre + spread * rng.standard_normal((NF, centre.size))


def _jstate(sc):
    return jba.BAState(X=sc.X, f=sc.K[:, 0, 0], u=sc.K[:, :2, 2], t=sc.t, R=sc.R)


def _render(st, dist, model):
    """(P, F, 2) distorted predictions of the JAX state ``st`` through
    ``model`` (JAX's ``_distorted_residual`` against zero)."""
    _, p, q, r = jba.calc_pqr(st.X, jba.build_K(st.f, st.u, 1.0), st.R, st.t)
    zero = jnp.zeros(p.shape + (2,))
    return np.asarray(jnp.stack(jba._distorted_residual(st, p, q, r, zero, 1.0,
                                                        jnp.asarray(dist), model), -1))


def _scene():
    return make_synthetic_scene(jax.random.key(0), n_images=NF, n_slices=3, n_angles=20,
                                dtype=jnp.float64)


def _problem(model, noise=0.002, seed=0, dtype=np.float64):
    """((x (P, F, 2), X0, K, R, t0) as numpy, the true distortion (F, n)):
    X and t start perturbed by 0.01 N(0, 1)."""
    sc = _scene()
    rng = np.random.default_rng(seed)
    dist = _truth(model, rng)
    x = _render(_jstate(sc), dist, model) + noise * rng.standard_normal((sc.X.shape[0], NF, 2))
    X0 = np.asarray(sc.X) + 0.01 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.01 * rng.standard_normal(sc.t.shape)
    prob = tuple(np.array(a, dtype=dtype, order="C")
                 for a in (x, X0, np.asarray(sc.K), np.asarray(sc.R), t0))
    return prob, dist


def _mask(shape, seed=3):
    return (np.random.default_rng(seed).uniform(size=shape) > 0.15).astype(np.float64)


def _normalized(model, masked, noise=0.002):
    """The start in the gauge frame, for both packages: (JAX state, port
    state, x, vis, free, dist) with x, vis, free, dist numpy."""
    (x, X0, K, R, t0), dist = _problem(model, noise=noise)
    vis = _mask(x.shape[:2]) if masked else np.ones(x.shape[:2])
    Xn, Rn, tn, _ = jba.normalize_gauge(jnp.asarray(X0), jnp.asarray(R), jnp.asarray(t0), AXIS)
    f, u = jba.intrinsics_from_K(jnp.asarray(K), 1.0)
    fields = [np.asarray(a) for a in (Xn, f, u, tn, Rn)]
    jstate = jba.BAState(*(jnp.asarray(a) for a in fields))
    tstate = ba_state_from_numpy(*fields, "cpu", torch.float64)
    free = np.asarray(jba.gauge_mask(NF, AXIS, jnp.float64))
    return jstate, tstate, x, vis, free, dist


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _close_k(got, want, tol):
    """Distortion parameters to ``tol`` of the largest in magnitude (at
    least 1): per camera, the high-order fisheye and full-OPENCV terms are
    barely identified on 60 points and run into the thousands, where both
    packages round the same ill-conditioned solve."""
    want = np.asarray(want)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------------ scales

S_GRID = np.array([[0.0, 1e-14, 5e-13, 1e-12, 2e-12, 1e-6, 0.01, 0.1, 0.3, 0.575]]).T


@pytest.mark.parametrize("name", ["_fisheye_scale", "_rational_scale", "_fov_scale",
                                  "_fov_domega"])
def test_scales_match_jax(name):
    """Each scale on s from 0 through the Taylor switch at 1e-12 to the
    scenes' largest s, per camera; the FOV ones also at the pinhole limit
    w = 0."""
    model = {"_fisheye_scale": "fisheye", "_rational_scale": "full_opencv"}.get(name, "fov")
    dist = _truth(model, np.random.default_rng(1))
    if model == "fov":
        dist[0, 0] = 0.0
        dist[1, 0] = 5e-7
    s = np.broadcast_to(S_GRID, (S_GRID.shape[0], NF))
    want = getattr(jba, name)(jnp.asarray(s), jnp.asarray(dist))
    got = getattr(tba, name)(*_t(s, dist))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.isfinite(g).all()
        _close(g, w, 1e-12)


# ------------------------------------------------- per-observation terms

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_terms_chain_and_residual_match_jax(model, masked):
    jstate, tstate, x, vis, free, dist = _normalized(model, masked)
    _, jp, jq, jr = jba.calc_pqr(jstate.X, jba.build_K(jstate.f, jstate.u, 1.0), jstate.R,
                                 jstate.t)
    jr = jnp.where(jnp.asarray(vis) > 0, jr, 1.0)
    tp, tq, tr = _t(jp, jq, jr)
    jd, td = jnp.asarray(dist), torch.from_numpy(dist)
    g1, g2 = (np.asarray(a / jr - jstate.u[:, i][None]) for i, a in enumerate((jp, jq)))
    if model == "thin_prism":
        with pytest.raises(ValueError, match="thin_prism"):
            tba._distortion_terms(tstate, tp, tq, tr, 1.0, td, model)
        for g, w in zip(tba._thin_prism_terms(tstate, *_t(g1, g2), 1.0, td),
                        jba._thin_prism_terms(jstate, g1, g2, 1.0, jd)):
            _close(g, w, 1e-12)
    else:
        for g, w in zip(tba._distortion_terms(tstate, tp, tq, tr, 1.0, td, model),
                        jba._distortion_terms(jstate, jp, jq, jr, 1.0, jd, model)):
            _close(g, w, 1e-12)
    if model == "full_opencv":  # p1, p2 from columns 6 and 7
        for g, w in zip(tba._tangential_terms(tstate, *_t(g1, g2), 1.0, td),
                        jba._tangential_terms(jstate, g1, g2, 1.0, jd)):
            _close(g, w, 1e-12)
    for g, w in zip(tba._distorted_residual(tstate, tp, tq, tr, torch.from_numpy(x), 1.0, td,
                                            model),
                    jba._distorted_residual(jstate, jp, jq, jr, jnp.asarray(x), 1.0, jd, model)):
        _close(g, w, 1e-12)
    # the chain on random factors (fresh copies: the port overwrites b)
    rng = np.random.default_rng(7)
    P = x.shape[0]
    fac = [rng.standard_normal((P, NF, k)) for k in (3, 3, 9, 9)]
    res = [rng.standard_normal((P, NF)) for _ in range(2)]
    want = jba._apply_distortion_chain(jstate, jp, jq, jr, 1.0, jd, *map(jnp.asarray, res + fac),
                                       model)
    got = tba._apply_distortion_chain(tstate, tp, tq, tr, 1.0, td, *_t(*res, *fac), model)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_compute_derivs_match_jax(model, masked):
    jstate, tstate, x, vis, free, dist = _normalized(model, masked)
    jd, je = jba._compute_derivs(jstate, jnp.asarray(x), jnp.asarray(vis), jnp.asarray(free),
                                 1.0, None, jnp.asarray(dist), model)
    td, te = tba._compute_derivs(tstate, *_t(x, vis, free), 1.0, torch.from_numpy(dist), model)
    _close(te, je, 1e-10)
    for name in ("d_P", "d_F", "matE", "matF", "matG"):
        _close(getattr(td, name), getattr(jd, name), 1e-10)


# ------------------------------------------------- autograd as the oracle

def _perturbed(state, X, cam):
    """The state moved by the BA parameterization: X, and per camera
    (f, u0, v0, t, omega) with R <- exp([omega]x) R."""
    return tba.BAState(X=X, f=state.f + cam[:, 0], u=state.u + cam[:, 1:3],
                       t=state.t + cam[:, 3:6], R=rodrigues(cam[:, 6:9]) @ state.R)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_gradients_and_gauss_newton_blocks_match_autograd(model, masked):
    """d_P, d_F against the gradient of the distorted E; matE, matF and
    matG against 2 JᵀJ of the distorted residuals weighted by vis (0 or
    1), J by ``torch.func.jacrev``: a slip in the chain's u or f column,
    or a symmetric D where thin prism's is not, shows here."""
    _, state, x, vis, free, dist = _normalized(model, masked, noise=0.01)
    x, vis, free, dist = _t(x, vis, free, dist)
    derivs, _ = tba._compute_derivs(state, x, vis, free, 1.0, dist, model)
    npts = state.X.shape[0]
    X = state.X.clone().requires_grad_(True)
    cam = torch.zeros((NF, 9), dtype=torch.float64, requires_grad=True)
    e = tba._state_error(_perturbed(state, X, cam), x, vis, 1.0, dist, model)
    gX, gcam = torch.autograd.grad(e, (X, cam))
    np.testing.assert_allclose(derivs.d_P.numpy(), gX.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.d_F.numpy(), (gcam.reshape(-1) * free).numpy(), atol=1e-9)

    def residuals(X, cam):
        res_p, res_q = tba._residuals(_perturbed(state, X, cam), x, vis, 1.0, dist, model)
        return torch.stack([vis * res_p, vis * res_q], dim=-1).reshape(-1)

    jX, jc = torch.func.jacrev(residuals, argnums=(0, 1))(state.X, torch.zeros((NF, 9),
                                                                           dtype=torch.float64))
    jX, jc = jX.reshape(-1, npts, 3), jc.reshape(-1, NF * 9)
    matE = 2.0 * torch.einsum("kpi,kpj->pij", jX, jX)
    matF = 2.0 * torch.einsum("kpi,km->pim", jX, jc) * free
    matG = 2.0 * torch.einsum("kfi,kfj->fij", jc.view(-1, NF, 9), jc.view(-1, NF, 9))
    np.testing.assert_allclose(derivs.matE.numpy(), matE.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.matF.numpy(), matF.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.matG.numpy(), matG.numpy(), atol=1e-9)


@pytest.mark.parametrize("model", ["fisheye", "fov", "thin_prism"])
def test_finite_gradients_at_the_principal_point(model):
    """A ray through the principal point (s = 0 exactly) takes the Taylor
    branch; the gradient of the residual through the guarded exact branch
    stays finite and equals JAX's."""
    dist = _truth(model, np.random.default_rng(4))
    u = np.random.default_rng(5).uniform(-0.01, 0.01, (NF, 2))
    f = np.full(NF, 1.2)
    # point 0 of every camera on its principal ray, the others off it
    g = np.random.default_rng(6).uniform(-0.3, 0.3, (3, NF, 2))
    g[0] = 0.0
    p, q = g[..., 0] + u[:, 0], g[..., 1] + u[:, 1]
    x = np.random.default_rng(7).uniform(-0.3, 0.3, (3, NF, 2))

    def jax_e(p, q, f, dist):
        st = jba.BAState(X=jnp.zeros((0, 3)), f=f, u=jnp.asarray(u), t=jnp.zeros((NF, 3)),
                         R=jnp.broadcast_to(jnp.eye(3), (NF, 3, 3)))
        rp, rq = jba._distorted_residual(st, p, q, jnp.ones_like(p), jnp.asarray(x), 1.0, dist,
                                         model)
        return jnp.sum(rp**2 + rq**2)

    want = jax.grad(jax_e, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (p, q, f, dist)))
    tp, tq, tf, td = (a.requires_grad_(True) for a in _t(p, q, f, dist))
    st = tba.BAState(X=torch.zeros((0, 3), dtype=torch.float64), f=tf,
                     u=torch.from_numpy(u), t=torch.zeros((NF, 3), dtype=torch.float64),
                     R=torch.eye(3, dtype=torch.float64).expand(NF, 3, 3))
    rp, rq = tba._distorted_residual(st, tp, tq, torch.ones_like(tp), torch.from_numpy(x), 1.0,
                                     td, model)
    got = torch.autograd.grad(torch.sum(rp**2 + rq**2), (tp, tq, tf, td))
    for gr, w in zip(got, want):
        assert torch.isfinite(gr).all()
        _close(gr, w, 1e-12)


# ------------------------------------------------------------- the refit

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shared", [False, True], ids=["per_camera", "shared"])
def test_fit_distortion_matches_jax(model, shared):
    jstate, tstate, x, vis, free, dist = _normalized(model, masked=True)
    start = 0.8 * dist  # where the iterative refits start
    want = jba.fit_distortion(jstate, jnp.asarray(x), jnp.asarray(vis), 1.0, shared=shared,
                              model=model, dist=jnp.asarray(start))
    got = tba.fit_distortion(tstate, *_t(x, vis), 1.0, shared=shared, model=model,
                             dist=torch.from_numpy(start))
    _close_k(got, want, 1e-8)
    if model in ("fov", "full_opencv"):  # and from the default start
        want = jba.fit_distortion(jstate, jnp.asarray(x), jnp.asarray(vis), 1.0, shared=shared,
                                  model=model)
        got = tba.fit_distortion(tstate, *_t(x, vis), 1.0, shared=shared, model=model)
        _close_k(got, want, 1e-8)
    if shared:  # FOV ties the step, so only from a shared start
        assert torch.equal(got, got[:1].expand_as(got))


@pytest.mark.parametrize("model", MODELS)
def test_fit_distortion_exact_recovery(model):
    """Noise-free observations at the true geometry: fisheye and thin prism
    are an exact linear solve, FOV's Gauss-Newton reaches the angle (to
    JAX's own tests' limits: 1e-6, 1e-7 and 1e-9 per camera, the high-order
    terms being ill-conditioned), and full OPENCV's alternation reaches the
    model as a function (zero residual, the same d(s) and exact (p1, p2);
    its k are not identified, as JAX's own test says)."""
    sc = _scene()
    js = _jstate(sc)
    state = ba_state_from_numpy(*(np.asarray(a) for a in js), "cpu", torch.float64)
    dist = _truth(model, np.random.default_rng(2))
    x = torch.from_numpy(_render(js, dist, model))
    ones = torch.ones(x.shape[:2], dtype=torch.float64)
    got = tba.fit_distortion(state, x, ones, 1.0, model=model)
    if model != "full_opencv":
        tol = {"fisheye": 1e-6, "thin_prism": 1e-7, "fov": 1e-9}[model]
        np.testing.assert_allclose(got.numpy(), dist, atol=tol)
        return
    e = tba._state_error(state, x, ones, 1.0, got, model)
    assert float(e) < 1e-10
    _, p, q, r = tba.calc_pqr(state.X, tba.build_K(state.f, state.u, 1.0), state.R, state.t)
    s = tba._distortion_terms(state, p, q, r, 1.0, got, model)[2]
    d_fit, _ = tba._rational_scale(s, got)
    d_true, _ = tba._rational_scale(s, torch.from_numpy(dist))
    assert float((d_fit - d_true).abs().max()) < 1e-5
    np.testing.assert_allclose(got[:, 6:8].numpy(), dist[:, 6:8], atol=1e-6)


def test_degenerate_cameras_as_in_jax():
    """A camera that sees nothing gets zeros from the 8x8 thin-prism solve,
    keeps its values through the full-OPENCV rounds and its angle through
    the FOV steps, as in JAX; the batch of solves does not raise."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((NF, 8, 10))
    m = a @ a.transpose(0, 2, 1)
    m[1] = 0.0
    m[2] = np.diag([1.0, 2.0, 3.0, 0.0, 0.0, 0.0, 0.0, 0.0])  # rank 3, positive trace
    terms = np.concatenate([m.reshape(NF, 64), rng.standard_normal((NF, 8))], -1)
    want = np.asarray(jba._solve_distortion_lsq(jnp.asarray(terms), False))
    got = tba._solve_distortion_lsq(torch.from_numpy(terms), False).numpy()
    np.testing.assert_array_equal(got[1:3], 0.0)
    np.testing.assert_array_equal(want[1:3], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    for model in ("full_opencv", "fov", "thin_prism"):
        jstate, tstate, x, vis, _, dist = _normalized(model, masked=False)
        vis[:, 4] = 0.0
        want = jba.fit_distortion(jstate, jnp.asarray(x), jnp.asarray(vis), 1.0, model=model,
                                  dist=jnp.asarray(dist))
        got = tba.fit_distortion(tstate, *_t(x, vis), 1.0, model=model,
                                 dist=torch.from_numpy(dist))
        want_4 = 0.0 if model == "thin_prism" else dist[4]
        np.testing.assert_array_equal(got[4].numpy(), want_4)
        _close_k(got, want, 1e-8)


# ------------------------------------------------------------ the dense core

DENSE_CASES = {
    "fisheye-fixed": ("fisheye", dict(max_iter=6), True),
    "fisheye-round-per-camera": ("fisheye", dict(max_iter=5, distortion_rounds=1), False),
    "full_opencv-fixed-huber": ("full_opencv", dict(max_iter=6, robust="huber",
                                                    huber_delta=0.004), True),
    "full_opencv-round-shared": ("full_opencv", dict(max_iter=5, distortion_rounds=1,
                                                     distortion_shared=True), False),
    "fov-fixed": ("fov", dict(max_iter=6), True),
    "fov-round-per-camera-cauchy": ("fov", dict(max_iter=5, distortion_rounds=1,
                                                robust="cauchy", huber_delta=0.004), False),
    "thin_prism-fixed": ("thin_prism", dict(max_iter=6), True),
    "thin_prism-round-shared": ("thin_prism", dict(max_iter=5, distortion_rounds=1,
                                                   distortion_shared=True), False),
}


def _run_dense(model, fields, fixed, dtype=np.float64):
    prob, dist = _problem(model, dtype=dtype)
    fields = dict(scale_factor=2.0, delta_tol=1e-12, distortion_model=model, **fields)
    d = dist.astype(dtype) if fixed else None
    want = jba.bundle_adjust(*map(jnp.asarray, prob), f0=1.0, axis=AXIS,
                             config=JLMConfig(**fields),
                             distortion=None if d is None else jnp.asarray(d))
    got = results_to_numpy(tba.bundle_adjust(*prob, f0=1.0, axis=AXIS, distortion=d,
                                              config=lm_config_from_fields(fields), device="cpu"))
    return got, want


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_bundle_adjust_matches_jax(case):
    model, fields, fixed = DENSE_CASES[case]
    got, want = _run_dense(model, fields, fixed)
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-8)
    np.testing.assert_allclose(got["X"], np.asarray(want.X), atol=1e-7)
    assert got["n_iter"] == int(want.n_iter)
    assert got["distortion"].shape == (NF, len(CENTRES[model][0]))
    _close_k(got["distortion"], want.distortion, 1e-8)


@pytest.mark.parametrize("model", MODELS)
def test_dense_float32_matches_jax(model):
    """float32, one refit round: the same final E to 1e-3 and iterations
    within one (the atan, tan and rational N/D round differently)."""
    fields = dict(max_iter=4, distortion_rounds=1, distortion_shared=True)
    got, want = _run_dense(model, fields, False, dtype=np.float32)
    assert got["error"].dtype == np.float32
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-3)
    assert abs(got["n_iter"] - int(want.n_iter)) <= 1


# ---------------------------------------------------- point (un)distortion

@pytest.mark.parametrize("model", ALL_MODELS)
def test_distort_and_undistort_points_match_jax(model):
    """Both maps against JAX's, and the round trip both ways to 1e-10, for
    every family; distort_points of the pinhole projection is the
    renderer."""
    sc = _scene()
    js = _jstate(sc)
    rng = np.random.default_rng(0)
    if model == "radial":
        dist = np.stack([-0.3 + 0.05 * rng.standard_normal(NF),
                         0.05 + 0.02 * rng.standard_normal(NF)], -1)
    elif model == "opencv":
        dist = np.stack([-0.28 + 0.03 * rng.standard_normal(NF),
                         0.035 + 0.01 * rng.standard_normal(NF),
                         0.018 + 0.005 * rng.standard_normal(NF),
                         -0.012 + 0.005 * rng.standard_normal(NF)], -1)
    else:
        dist = _truth(model, rng)
    _, p, q, r = jba.calc_pqr(js.X, jba.build_K(js.f, js.u, 1.0), js.R, js.t)
    x_pin = np.asarray(jnp.stack([p / r, q / r], -1))
    f, u = np.asarray(js.f), np.asarray(js.u)
    want_d = jba.distort_points(jnp.asarray(x_pin), js.f, js.u, 1.0, jnp.asarray(dist), model)
    got_d = tba.distort_points(*_t(x_pin, f, u), 1.0, torch.from_numpy(dist), model)
    _close(got_d, want_d, 1e-12)
    _close(got_d, _render(js, dist, model), 1e-12)
    want_u = jba.undistort_points(want_d, js.f, js.u, 1.0, jnp.asarray(dist), model)
    got_u = tba.undistort_points(got_d, *_t(f, u), 1.0, torch.from_numpy(dist), model)
    _close(got_u, want_u, 1e-12)
    _close(got_u, x_pin, 1e-10)
    fwd = tba.distort_points(got_u, *_t(f, u), 1.0, torch.from_numpy(dist), model)
    _close(fwd, got_d, 1e-10)
    assert tba.undistort_points(got_d, *_t(f, u)) is got_d  # no distortion: unchanged
