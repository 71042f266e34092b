"""Lens distortion (BAL radial and OPENCV) in the port's dense core, held
against the JAX package on the CPU on the same numpy inputs: the curved
tube in 6 views, rendered through each model with JAX's own
``_distortion_terms`` / ``_tangential_terms``.

- ``resolve_distortion_model`` spellings and errors (an explicit fisheye
  with 4 columns is not OPENCV, and runs as JAX's fisheye does; the other
  families of the second slice pass the checks), ``default_distortion``
  and ``distortion_nterms``;
- ``_distortion_terms``, ``_tangential_terms``, ``_apply_distortion_chain``
  and ``_distorted_residual`` in float64 to 1e-12, with and without a mask;
  ``_compute_derivs`` with each model to 1e-10;
- an independent check by ``torch.autograd``: d_P and d_F against the
  gradient of the distorted E, and matE, matF, matG against 2 JᵀJ of the
  distorted residuals' Jacobian;
- ``fit_distortion`` per camera and shared against JAX (1e-10), exact
  recovery on noise-free data, and a singular camera given zeros without
  an exception, as JAX gives them;
- dense ``bundle_adjust`` with the model fixed and with
  ``distortion_rounds=2``, plain and Huber, in float64 (E rtol 1e-8, X
  atol 1e-7, the same iterations, k atol 1e-8) and float32 (E rtol 1e-3,
  iterations within one).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import (
    ba_state_from_numpy,
    distortion_from_numpy,
    lm_config_from_fields,
    results_to_numpy,
)
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.ops.rotations import rodrigues

AXIS = "x-up_z-forward"
NF = 6
# per-camera truths around bench_bal.py's radial (-0.3, 0.05) and the
# OPENCV truth of tests/test_distortion.py's e2e test
TRUTH = {
    "radial": lambda rng: np.stack([-0.3 + 0.03 * rng.standard_normal(NF),
                                    0.05 + 0.01 * rng.standard_normal(NF)], -1),
    "opencv": lambda rng: np.stack([-0.28 + 0.03 * rng.standard_normal(NF),
                                    0.035 + 0.01 * rng.standard_normal(NF),
                                    0.018 + 0.005 * rng.standard_normal(NF),
                                    -0.012 + 0.005 * rng.standard_normal(NF)], -1),
}
MODELS = list(TRUTH)
SECOND_FAMILIES = (("fisheye", 4), ("full_opencv", 8), ("fov", 1), ("thin_prism", 8))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(sc, dist):
    """(P, F, 2) observations of the scene through the model of ``dist``
    (JAX's terms, float64)."""
    st = jba.BAState(X=sc.X, f=sc.K[:, 0, 0], u=sc.K[:, :2, 2], t=sc.t, R=sc.R)
    _, p, q, r = jba.calc_pqr(st.X, jba.build_K(st.f, st.u, 1.0), st.R, st.t)
    dist = jnp.asarray(dist)
    g1, g2, _, d, _ = jba._distortion_terms(st, p, q, r, 1.0, dist)
    x1, x2 = d * g1 + st.u[:, 0][None], d * g2 + st.u[:, 1][None]
    if dist.shape[-1] == 4:
        t1, t2, _, _, _ = jba._tangential_terms(st, g1, g2, 1.0, dist)
        x1, x2 = x1 + t1, x2 + t2
    return np.asarray(jnp.stack([x1, x2], -1))


def _problem(model, noise=0.002, n_slices=3, seed=0, dtype=np.float64):
    """((x (P, F, 2), X0, K, R, t0) as numpy, the true distortion (F, n),
    the true X): X and t start perturbed by 0.01 N(0, 1)."""
    sc = make_synthetic_scene(jax.random.key(seed), n_images=NF, n_slices=n_slices,
                              n_angles=20, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    dist = TRUTH[model](rng)
    x = _render(sc, dist) + noise * rng.standard_normal((sc.X.shape[0], NF, 2))
    X0 = np.asarray(sc.X) + 0.01 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.01 * rng.standard_normal(sc.t.shape)
    prob = tuple(np.array(a, dtype=dtype, order="C")
                 for a in (x, X0, np.asarray(sc.K), np.asarray(sc.R), t0))
    return prob, dist, np.asarray(sc.X)


def _mask(shape, seed=3):
    return (np.random.default_rng(seed).uniform(size=shape) > 0.15).astype(np.float64)


def _normalized(model, masked, noise=0.002):
    """The start in the gauge frame, for both packages: (JAX state, port
    state, x, vis, free, dist) with x, vis, free, dist numpy."""
    (x, X0, K, R, t0), dist, _ = _problem(model, noise=noise)
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


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------ model resolution

def test_resolve_distortion_model_spellings_and_errors():
    for ncols in (1, 2, 4, 8):
        d = np.zeros((NF, ncols))
        assert tba.resolve_distortion_model(d) == jba.resolve_distortion_model(d)
        assert tba.resolve_distortion_model(d, None) == jba.resolve_distortion_model(d, None)
    assert tba.resolve_distortion_model(None) == "radial"
    for name, ncols in jba._DISTORTION_NCOLS.items():
        assert tba._DISTORTION_NCOLS[name] == ncols
        assert tba.resolve_distortion_model(np.zeros((NF, ncols)), name) == name
        assert tba.resolve_distortion_model(None, name) == name
    # an explicit fisheye with 4 columns is fisheye, not OPENCV
    assert tba.resolve_distortion_model(np.zeros((NF, 4)), "fisheye") == "fisheye"
    for dist, model, match in ((np.zeros((NF, 3)), "auto", "columns"),
                               (np.zeros((NF, 4)), "radial", "columns"),
                               (np.zeros((NF, 2)), "opencv", "columns"),
                               (None, "bogus", "unknown distortion model")):
        with pytest.raises(ValueError, match=match):
            tba.resolve_distortion_model(dist, model)
        with pytest.raises(ValueError):
            jba.resolve_distortion_model(dist, model)
    prob, _, _ = _problem("opencv")
    fields = dict(distortion_model="fisheye", max_iter=1, scale_factor=2.0)
    want = jba.bundle_adjust(*map(jnp.asarray, prob), axis=AXIS, config=JLMConfig(**fields),
                             distortion=jnp.zeros((NF, 4)))
    got = tba.bundle_adjust(*prob, axis=AXIS, config=LMConfig(**fields),
                            distortion=np.zeros((NF, 4)), device="cpu")
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-8)
    # at k = 0 the fisheye base theta/|rho| is no pinhole, as OPENCV's is
    opencv = tba.bundle_adjust(*prob, axis=AXIS, config=LMConfig(max_iter=1, scale_factor=2.0),
                               distortion=np.zeros((NF, 4)), device="cpu")
    assert abs(float(opencv.error) - float(got.error)) > 1e-3 * float(got.error)
    with pytest.raises(ValueError, match="columns"):
        tba.bundle_adjust(*prob, axis=AXIS, config=LMConfig(distortion_model="radial"),
                          distortion=np.zeros((NF, 4)), device="cpu")
    for model, ncols in SECOND_FAMILIES:
        assert tba.resolve_distortion_model(np.zeros((NF, ncols)), model) == model
        cfg = LMConfig(distortion_model=model, distortion_rounds=1)
        assert tba._check_config(cfg, dist=np.zeros((NF, ncols))) == model
    # a model named in the config alone changes nothing for a pinhole run
    res = tba.bundle_adjust(*prob, axis=AXIS, device="cpu",
                            config=LMConfig(distortion_model="fisheye", max_iter=1))
    assert res.distortion is None


@pytest.mark.parametrize("model", [m for m, _ in SECOND_FAMILIES] + MODELS)
def test_default_distortion_and_nterms(model):
    want = np.asarray(jba.default_distortion(model, NF, jnp.float64))
    got = tba.default_distortion(model, NF, torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert tba.distortion_nterms(model) == jba.distortion_nterms(model)


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
    for g, w in zip(tba._distortion_terms(tstate, tp, tq, tr, 1.0, td),
                    jba._distortion_terms(jstate, jp, jq, jr, 1.0, jd)):
        _close(g, w, 1e-12)
    if model == "opencv":
        g1, g2 = (jp / jr - jstate.u[:, i][None] for i in (0, 1))
        for g, w in zip(tba._tangential_terms(tstate, *_t(g1, g2), 1.0, td),
                        jba._tangential_terms(jstate, g1, g2, 1.0, jd)):
            _close(g, w, 1e-12)
    for g, w in zip(tba._distorted_residual(tstate, tp, tq, tr, torch.from_numpy(x), 1.0, td),
                    jba._distorted_residual(jstate, jp, jq, jr, jnp.asarray(x), 1.0, jd)):
        _close(g, w, 1e-12)
    # the chain on random factors (fresh copies: the port overwrites b)
    rng = np.random.default_rng(7)
    P = x.shape[0]
    fac = [rng.standard_normal((P, NF, k)) for k in (3, 3, 9, 9)]
    res = [rng.standard_normal((P, NF)) for _ in range(2)]
    want = jba._apply_distortion_chain(jstate, jp, jq, jr, 1.0, jd, *map(jnp.asarray, res + fac))
    got = tba._apply_distortion_chain(tstate, tp, tq, tr, 1.0, td, *_t(*res, *fac))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_compute_derivs_match_jax(model, masked):
    jstate, tstate, x, vis, free, dist = _normalized(model, masked)
    jd, je = jba._compute_derivs(jstate, jnp.asarray(x), jnp.asarray(vis), jnp.asarray(free),
                                 1.0, None, jnp.asarray(dist))
    td, te = tba._compute_derivs(tstate, *_t(x, vis, free), 1.0, torch.from_numpy(dist))
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
    1), J by ``torch.func.jacrev``: a slip in the chain's u or f column
    shows here."""
    _, state, x, vis, free, dist = _normalized(model, masked, noise=0.01)
    x, vis, free, dist = _t(x, vis, free, dist)
    derivs, _ = tba._compute_derivs(state, x, vis, free, 1.0, dist)
    npts = state.X.shape[0]
    X = state.X.clone().requires_grad_(True)
    cam = torch.zeros((NF, 9), dtype=torch.float64, requires_grad=True)
    e = tba._state_error(_perturbed(state, X, cam), x, vis, 1.0, dist)
    gX, gcam = torch.autograd.grad(e, (X, cam))
    np.testing.assert_allclose(derivs.d_P.numpy(), gX.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.d_F.numpy(), (gcam.reshape(-1) * free).numpy(), atol=1e-9)

    def residuals(X, cam):
        res_p, res_q = tba._residuals(_perturbed(state, X, cam), x, vis, 1.0, dist)
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


# ------------------------------------------------------------- the refit

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shared", [False, True], ids=["per_camera", "shared"])
def test_fit_distortion_matches_jax(model, shared):
    jstate, tstate, x, vis, free, _ = _normalized(model, masked=True)
    want = jba.fit_distortion(jstate, jnp.asarray(x), jnp.asarray(vis), 1.0, shared=shared,
                              model=model)
    got = tba.fit_distortion(tstate, *_t(x, vis), 1.0, shared=shared, model=model)
    _close(got, want, 1e-10)
    if shared:
        assert torch.equal(got, got[:1].expand_as(got))


@pytest.mark.parametrize("model", MODELS)
def test_fit_distortion_exact_recovery(model):
    """Noise-free observations at the true geometry: the refit is an exact
    linear solve, per camera and, for a shared truth, tied."""
    sc = make_synthetic_scene(jax.random.key(0), n_images=NF, n_slices=3, n_angles=20,
                              dtype=jnp.float64)
    state = ba_state_from_numpy(np.asarray(sc.X), np.asarray(sc.K[:, 0, 0]),
                                np.asarray(sc.K[:, :2, 2]), np.asarray(sc.t), np.asarray(sc.R),
                                "cpu", torch.float64)
    dist = TRUTH[model](np.random.default_rng(2))
    x = torch.from_numpy(_render(sc, dist))
    ones = torch.ones(x.shape[:2], dtype=torch.float64)
    got = tba.fit_distortion(state, x, ones, 1.0, model=model)
    np.testing.assert_allclose(got.numpy(), dist, atol=1e-9)
    shared = np.broadcast_to(dist[:1], dist.shape)
    x_s = torch.from_numpy(_render(sc, shared))
    got = tba.fit_distortion(state, x_s, ones[:, :1], 1.0, shared=True,
                             tangential=model == "opencv")
    np.testing.assert_allclose(got.numpy(), shared, atol=1e-9)


def test_singular_camera_gets_zeros_as_in_jax():
    """A camera with no visible observation (zero trace) and one whose 4x4
    normal matrix is singular get zeros, the others their solution; the
    batch of solves does not raise."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((NF, 4, 6))
    m = a @ a.transpose(0, 2, 1)
    m[1] = 0.0
    m[2] = np.diag([1.0, 2.0, 0.0, 0.0])  # rank 2, positive trace
    rhs = rng.standard_normal((NF, 4))
    terms = np.concatenate([m.reshape(NF, 16), rhs], -1)
    want = np.asarray(jba._solve_distortion_lsq(jnp.asarray(terms), False))
    got = tba._solve_distortion_lsq(torch.from_numpy(terms), False).numpy()
    np.testing.assert_array_equal(got[1:3], 0.0)
    np.testing.assert_array_equal(want[1:3], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    with pytest.raises(RuntimeError):  # what a plain solve would do to the batch
        torch.linalg.solve(torch.from_numpy(m[2:3]), torch.from_numpy(rhs[2:3, :, None]))
    # the radial 2x2 solve: a zero camera gets zeros too
    t5 = rng.standard_normal((NF, 5))
    t5[:, 0] = t5[:, 2] = np.abs(t5[:, 0]) + 3.0
    t5[3] = 0.0
    want = np.asarray(jba._solve_distortion_lsq(jnp.asarray(t5), False))
    got = tba._solve_distortion_lsq(torch.from_numpy(t5), False).numpy()
    np.testing.assert_array_equal(got[3], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    # a camera that sees nothing, through the whole refit
    jstate, tstate, x, vis, _, _ = _normalized("opencv", masked=False)
    vis[:, 4] = 0.0
    want = jba.fit_distortion(jstate, jnp.asarray(x), jnp.asarray(vis), 1.0, tangential=True)
    got = tba.fit_distortion(tstate, *_t(x, vis), 1.0, tangential=True)
    np.testing.assert_array_equal(got[4].numpy(), 0.0)
    _close(got, want, 1e-10)


# ------------------------------------------------------------ the dense core

DENSE_CASES = {
    "radial-fixed": ("radial", dict(max_iter=8), True),
    "opencv-fixed-huber": ("opencv", dict(max_iter=8, robust="huber", huber_delta=0.004), True),
    "radial-rounds-per-camera": ("radial", dict(max_iter=6, distortion_rounds=2), False),
    "radial-rounds-shared-huber": ("radial", dict(max_iter=6, distortion_rounds=2,
                                                  distortion_shared=True, robust="huber",
                                                  huber_delta=0.004), False),
    "opencv-rounds-shared": ("opencv", dict(max_iter=6, distortion_rounds=2,
                                            distortion_model="opencv",
                                            distortion_shared=True), False),
    "opencv-rounds-per-camera-cauchy": ("opencv", dict(max_iter=6, distortion_rounds=2,
                                                       distortion_model="opencv",
                                                       robust="cauchy", huber_delta=0.004),
                                        False),
}


def _run_dense(model, fields, fixed, dtype=np.float64):
    prob, dist, _ = _problem(model, dtype=dtype)
    fields = dict(scale_factor=2.0, delta_tol=1e-12, **fields)
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
    assert got["distortion"].shape == (NF, 2 if model == "radial" else 4)
    np.testing.assert_allclose(got["distortion"], np.asarray(want.distortion), atol=1e-8)


def test_dense_rounds_count_every_segment():
    """With n rounds there are n refits and n + 1 LM segments: ``n_iter``
    and the retries count all of them, the recorded log the last one."""
    prob, _, _ = _problem("radial")
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=2, distortion_rounds=2,
                   record_log=True)
    res = tba.bundle_adjust(*prob, axis=AXIS, config=cfg, device="cpu")
    assert res.n_iter == 6 and res.log["n_solver_retries"] >= 6
    assert res.log["reprojection_error"].shape == (3,)
    assert float(res.log["reprojection_error"][-1]) == float(res.error)


def test_dense_float32_matches_jax():
    model, fields, fixed = DENSE_CASES["radial-rounds-shared-huber"]
    got, want = _run_dense(model, fields, fixed, dtype=np.float32)
    assert got["error"].dtype == np.float32
    np.testing.assert_allclose(float(got["error"]), float(want.error), rtol=1e-3)
    assert abs(got["n_iter"] - int(want.n_iter)) <= 1


def test_lanes_take_no_distortion():
    """Distortion is for one problem: with a lane dimension it raises, as
    the JAX package's batched paths take none."""
    prob, dist, _ = _problem("radial")
    lanes = [np.stack([a, a]) for a in prob]
    for kw, cfg in (({"distortion": dist}, LMConfig(max_iter=1)),
                    ({}, LMConfig(max_iter=1, distortion_rounds=1))):
        with pytest.raises(ValueError, match="one problem"):
            tba.bundle_adjust(*lanes, axis=AXIS, config=cfg, device="cpu", **kw)


def test_distortion_from_numpy_takes_the_problem_dtype_and_device():
    like = torch.zeros(3, dtype=torch.float32)
    d = distortion_from_numpy(np.zeros((NF, 4)), like)
    assert d.dtype == torch.float32 and d.device == like.device and d.shape == (NF, 4)
