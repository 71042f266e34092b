"""Parity of the port's dense bundle adjustment with the JAX package on the
CPU, on the same numpy inputs:

- float64 algebra: the derivative blocks (``_compute_derivs`` with a
  visibility mask) to 1e-10 and the damped solve from either side
  (``_damped_solve``) to 1e-9 of the largest entry, fixed gauge entries
  exactly zero;
- float64 ``bundle_adjust`` across both damping schedules, both gauge
  axes, visibility and the recorded log: E to 1e-8, X, K, R, t to 1e-6,
  the same iterations and final damping; a resumed run equals one run;
- an indefinite damped system rejects the trial instead of raising;
- float32 ``bundle_adjust``: E to 1e-3, iterations within one;
- an independent check of the algebra by ``torch.autograd``: d_P and d_F
  against the gradient of E, and matE, matF, matG against 2 JᵀJ of the
  residual Jacobian from ``torch.func.jacrev``;
- ``triangulate`` with and without visibility.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu.ops.triangulation import triangulate as j_triangulate
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import ba_state_from_numpy, lm_config_from_fields, results_to_numpy
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.ops.rotations import rodrigues
from mvrecon_tpu_torch.ops import linalg as tlin
from mvrecon_tpu_torch.ops.triangulation import triangulate as t_triangulate

AXIS = "x-up_z-forward"


def _problem(nf, n_slices, dtype=np.float64, seed=5):
    """Noisy observations (P, F, 2) of the curved tube and a start with X
    and t perturbed by 0.02 N(0, 1), as numpy: (x, X0, K, R, t0)."""
    sc = make_synthetic_scene(jax.random.key(seed), n_images=nf, n_slices=n_slices,
                              n_angles=20, dtype=jnp.float64, noise=0.003)
    rng = np.random.default_rng(seed)
    X0 = np.asarray(sc.X) + 0.02 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.02 * rng.standard_normal(sc.t.shape)
    arrs = (np.asarray(sc.x).transpose(1, 0, 2), X0, np.asarray(sc.K), np.asarray(sc.R), t0)
    return tuple(np.array(a, dtype=dtype, order="C") for a in arrs)


def _mask(shape, seed=1):
    return (np.random.default_rng(seed).uniform(size=shape) > 0.15).astype(np.float64)


def _close(got, want, tol):
    """To ``tol`` of the largest entry: the same float64 algebra, summed in
    another order."""
    w = np.asarray(want)
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(np.abs(w).max(), 1e-300))


def _normalized(nf, n_slices, axis=AXIS, masked=False):
    """The start of ``_problem`` in the normalized gauge, float64: the state
    as numpy fields (X, f, u, t, R), x, vis and the gauge mask."""
    x, X0, K, R, t0 = _problem(nf, n_slices)
    Xn, Rn, tn, _ = jba.normalize_gauge(jnp.asarray(X0), jnp.asarray(R), jnp.asarray(t0), axis)
    f, u = jba.intrinsics_from_K(jnp.asarray(K), 1.0)
    fields = [np.array(a) for a in (Xn, f, u, tn, Rn)]
    vis = _mask(x.shape[:2]) if masked else np.ones(x.shape[:2])
    free = np.array(jba.gauge_mask(nf, axis, jnp.float64))
    return fields, np.where(vis[..., None] > 0, x, 0.0), vis, free


DERIV_KEYS = ("d_P", "d_F", "matE", "matF", "matG")


@jax.jit
def _j_derivs(state, x, vis, free):
    """JAX's blocks under one ``jit`` (op by op, each op would compile on
    its own): (the five blocks in ``DERIV_KEYS`` order, E)."""
    derivs, e = jba._compute_derivs(state, x, vis, free, 1.0)
    return tuple(getattr(derivs, k) for k in DERIV_KEYS), e


@jax.jit
def _j_damped_solve(blocks, c, free):
    return jba._damped_solve(jba._Derivs(*blocks), c, free)


def _both_derivs(nf, n_slices, masked):
    fields, x, vis, free = _normalized(nf, n_slices, masked=masked)
    jst = jba.BAState(*(jnp.asarray(a) for a in fields))
    want, e_want = _j_derivs(jst, *(jnp.asarray(a) for a in (x, vis, free)))
    tst = ba_state_from_numpy(*fields, "cpu", torch.float64)
    got, e_got = tba._compute_derivs(tst, *(torch.from_numpy(a) for a in (x, vis, free)), 1.0)
    return (fields, x, vis, free), (tba._Derivs(*want), e_want), (got, e_got)


def test_compute_derivs_with_visibility_matches_jax():
    _, (want, e_want), (got, e_got) = _both_derivs(6, 5, masked=True)
    for key in DERIV_KEYS:
        _close(getattr(got, key), getattr(want, key), 1e-10)
    _close(e_got, e_want, 1e-10)


@pytest.mark.parametrize("nf,n_slices", [(8, 10), (12, 1)], ids=["point-side", "camera-side"])
def test_damped_solve_matches_jax(nf, n_slices):
    """P = 200, F = 8 eliminates the points; P = 20, F = 12 (3P < 9F)
    eliminates the cameras. Both get the same (JAX) blocks."""
    (_, _, _, free), (want, _), _ = _both_derivs(nf, n_slices, masked=False)
    assert (want.matE.shape[0] * 3 < want.matF.shape[2]) == (n_slices == 1)
    c = 3e-3
    j_dxi, j_dx = _j_damped_solve(tuple(want), jnp.float64(c), jnp.asarray(free))
    t_derivs = tba._Derivs(*(torch.from_numpy(np.array(b)) for b in want))
    t_dxi, t_dx = tba._damped_solve(t_derivs, c, torch.from_numpy(free))
    _close(t_dxi, j_dxi, 1e-9)
    _close(t_dx, j_dx, 1e-9)
    assert torch.all(t_dxi[free == 0] == 0)


@pytest.mark.parametrize("nf,n_slices", [(8, 10), (12, 1)], ids=["point-side", "camera-side"])
def test_indefinite_system_gives_nan_step(nf, n_slices):
    """Negated camera blocks make the damped system indefinite: the solve
    returns a NaN step where the Cholesky factor fails, and raises not."""
    _, _, (got, _) = _both_derivs(nf, n_slices, masked=False)
    bad = got._replace(matG=-got.matG)
    dxi, _ = tba._damped_solve(bad, 1e-3, tba.gauge_mask(nf, AXIS, torch.float64))
    assert torch.isnan(dxi).all()


def test_indefinite_system_rejects_the_trial(monkeypatch):
    """In the LM loop such a step is rejected at every damping level: the
    state and error stay, and the loop stops after one iteration."""
    fields, x, vis, free = _normalized(6, 5)
    state0 = ba_state_from_numpy(*fields, "cpu", torch.float64)
    x_t, vis_t, free_t = (torch.from_numpy(a) for a in (x, vis, free))
    real = tba._compute_derivs

    def indefinite(*args):
        derivs, e = real(*args)
        return derivs._replace(matG=-derivs.matG), e

    monkeypatch.setattr(tba, "_compute_derivs", indefinite)
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=5, max_inner_retries=3)
    state, e, c, _, n_iter, _ = tba.lm_optimize(x_t, state0, vis_t, free_t, 1.0, cfg)
    assert n_iter == 1
    assert float(e) == float(tba._state_error(state0, x_t, vis_t, 1.0))
    assert torch.equal(state.X, state0.X)
    np.testing.assert_allclose(float(c), 1e-4 * 2.0**3 / 2.0)


NIELSEN = dict(scale_factor=4.0, delta_tol=0.0, max_iter=6, accept_divisor=1.0,
               init_damping=3e-3, damping="nielsen")
REFERENCE = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=6)
F64_CASES = {
    # damping, gauge axis, visibility mask, recorded log
    "reference-xup": (REFERENCE, "x-up_z-forward", False, False),
    "reference-xright-log": (dict(REFERENCE, record_log=True), "x-right_z-forward", False, True),
    "nielsen-xright-masked": (NIELSEN, "x-right_z-forward", True, False),
    "nielsen-xup-masked-log": (dict(NIELSEN, record_log=True), "x-up_z-forward", True, True),
}


def _run_both(prob, fields, axis, visibility=None, **kw):
    jres = jba.bundle_adjust(*(jnp.asarray(a) for a in prob), f0=1.0,
                             visibility=None if visibility is None else jnp.asarray(visibility),
                             axis=axis, config=JLMConfig(**fields), **kw)
    tres = tba.bundle_adjust(*prob, f0=1.0, visibility=visibility, axis=axis,
                             config=lm_config_from_fields(fields), device="cpu", **kw)
    return jres, results_to_numpy(tres)


@pytest.mark.parametrize("case", list(F64_CASES))
def test_bundle_adjust_float64_matches_jax(case):
    fields, axis, masked, logged = F64_CASES[case]
    prob = _problem(6, 5)
    vis = _mask(prob[0].shape[:2]) if masked else None
    jres, tres = _run_both(prob, fields, axis, vis)
    np.testing.assert_allclose(float(tres["error"]), float(jres.error), rtol=1e-8)
    assert tres["n_iter"] == int(jres.n_iter)
    for key in ("X", "K", "R", "t"):
        np.testing.assert_allclose(tres[key], np.asarray(getattr(jres, key)), rtol=1e-6, atol=1e-8)
    for key in ("c", "nu"):
        np.testing.assert_allclose(tres["log"][key], float(jres.log[key]), rtol=1e-8)
    assert ("reprojection_error" in tres["log"]) == logged
    if logged:
        for key in ("points", "basis", "pos", "reprojection_error"):
            assert tres["log"][key].shape == jres.log[key].shape
            np.testing.assert_allclose(tres["log"][key], np.asarray(jres.log[key]),
                                       rtol=1e-6, atol=1e-8)
        assert tres["log"]["reprojection_error"][0] > tres["error"]


def test_segmented_resume_equals_one_run():
    """Two segments of 3 iterations, the second resumed from the first's
    (c, nu) and state, equal one run of 6 (Nielsen, where nu matters)."""
    x, X0, K, R, t0 = _problem(6, 5)
    cfg = LMConfig(**NIELSEN)
    one = tba.bundle_adjust(x, X0, K, R, t0, axis=AXIS, config=cfg, device="cpu")
    half = dataclasses.replace(cfg, max_iter=3)
    a = tba.bundle_adjust(x, X0, K, R, t0, axis=AXIS, config=half, device="cpu")
    b = tba.bundle_adjust(x, a.X, a.K, a.R, a.t, axis=AXIS, config=half,
                          init_c=a.log["c"], init_nu=a.log["nu"], device="cpu")
    assert a.n_iter + b.n_iter == one.n_iter == 6
    np.testing.assert_allclose(float(b.error), float(one.error), rtol=1e-10)
    for key in ("X", "K", "R", "t"):
        np.testing.assert_allclose(getattr(b, key).numpy(), getattr(one, key).numpy(),
                                   rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(b.log["c"]), float(one.log["c"]), rtol=1e-8)
    np.testing.assert_allclose(float(b.log["nu"]), float(one.log["nu"]), rtol=1e-8)


@pytest.mark.parametrize("damping", ["reference", "nielsen"])
def test_bundle_adjust_float32_matches_jax(damping):
    prob = _problem(6, 5, np.float32)
    fields = dict(NIELSEN if damping == "nielsen" else REFERENCE, delta_tol=0.0, max_iter=5)
    jres, tres = _run_both(prob, fields, AXIS)
    assert tres["error"].dtype == np.float32
    np.testing.assert_allclose(float(tres["error"]), float(jres.error), rtol=1e-3)
    assert abs(tres["n_iter"] - int(jres.n_iter)) <= 1


SECOND_DISTORTION = (("fisheye", 4), ("full_opencv", 8), ("fov", 1), ("thin_prism", 8))


def test_solver_hook_and_second_distortion_families():
    """``lm_optimize(solver=_damped_solve)`` gives the run without a solver
    bit for bit, and a wrapping solver is called once a retry (the 2D BA
    plugs its CG in there). The distortion families of the second slice,
    which raised here before, run as JAX's ``bundle_adjust`` does, refit
    from their default start and given (E rtol 1e-8, the same
    iterations)."""
    prob = _problem(6, 5)
    for model, ncols in SECOND_DISTORTION:
        given = np.full((6, ncols), 0.5 if model == "fov" else 0.01)
        for fields, dist in ((dict(distortion_rounds=1), None), ({}, given)):
            fields = dict(fields, distortion_model=model, max_iter=2, scale_factor=2.0)
            want = jba.bundle_adjust(*map(jnp.asarray, prob), config=JLMConfig(**fields),
                                     distortion=None if dist is None else jnp.asarray(dist))
            got = tba.bundle_adjust(*prob, config=LMConfig(**fields), distortion=dist,
                                    device="cpu")
            np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-8,
                                       err_msg=model)
            assert got.n_iter == int(want.n_iter) and got.distortion.shape == (6, ncols)
    fields, x, vis, free = _normalized(6, 5)
    state = ba_state_from_numpy(*fields, "cpu", torch.float64)
    args = [torch.from_numpy(a) for a in (x,)] + [state] + [torch.from_numpy(a) for a in (vis, free)]
    cfg = LMConfig(scale_factor=2.0, max_iter=4)
    plain = tba.lm_optimize(*args, 1.0, cfg)
    hooked = tba.lm_optimize(*args, 1.0, cfg, solver=tba._damped_solve)
    for u, v in zip(list(plain[0]) + list(plain[1:4]), list(hooked[0]) + list(hooked[1:4])):
        assert torch.equal(u, v)
    assert hooked[4] == plain[4] > 0
    calls = []

    def wrapping(derivs, c, free, axis_name):
        calls.append(axis_name)
        return tba._damped_solve(derivs, c, free, axis_name)

    wrapped = tba.lm_optimize(*args, 1.0, cfg, solver=wrapping)
    assert torch.equal(wrapped[1], plain[1]) and wrapped[4] == plain[4]
    retries = tba.lm_lanes(*args, 1.0, cfg).retries
    assert calls == [None] * retries and retries >= plain[4]


# ------------------------------------------------- autograd as the oracle

def _autograd_state(masked):
    fields, x, vis, free = _normalized(6, 5, masked=masked)
    state = ba_state_from_numpy(*fields, "cpu", torch.float64)
    return state, *(torch.from_numpy(a) for a in (x, vis, free))


def _perturbed(state, X, cam):
    """The state moved by the BA parameterization: X, and per camera
    (f, u0, v0, t, omega) with R <- exp([omega]x) R."""
    return tba.BAState(X=X, f=state.f + cam[:, 0], u=state.u + cam[:, 1:3],
                       t=state.t + cam[:, 3:6], R=rodrigues(cam[:, 6:9]) @ state.R)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_gradients_match_autograd(masked):
    state, x, vis, free = _autograd_state(masked)
    derivs, _ = tba._compute_derivs(state, x, vis, free, 1.0)
    X = state.X.clone().requires_grad_(True)
    cam = torch.zeros((state.f.shape[0], 9), dtype=torch.float64, requires_grad=True)
    e = tba._state_error(_perturbed(state, X, cam), x, vis, 1.0)
    gX, gcam = torch.autograd.grad(e, (X, cam))
    np.testing.assert_allclose(derivs.d_P.numpy(), gX.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.d_F.numpy(), (gcam.reshape(-1) * free).numpy(), atol=1e-9)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_gauss_newton_blocks_are_jtj(masked):
    """matE, matF and matG are the blocks of 2 JᵀJ for the residuals
    weighted by vis (0 or 1), J taken by ``torch.func.jacrev``."""
    state, x, vis, free = _autograd_state(masked)
    derivs, _ = tba._compute_derivs(state, x, vis, free, 1.0)
    npts, nf = state.X.shape[0], state.f.shape[0]

    def residuals(X, cam):
        res_p, res_q = tba._residuals(_perturbed(state, X, cam), x, vis, 1.0)
        return torch.stack([vis * res_p, vis * res_q], dim=-1).reshape(-1)

    cam0 = torch.zeros((nf, 9), dtype=torch.float64)
    jX, jc = torch.func.jacrev(residuals, argnums=(0, 1))(state.X, cam0)
    jX, jc = jX.reshape(-1, npts, 3), jc.reshape(-1, nf * 9)
    matE = 2.0 * torch.einsum("kpi,kpj->pij", jX, jX)
    matF = 2.0 * torch.einsum("kpi,km->pim", jX, jc) * free
    matG = 2.0 * torch.einsum("kfi,kfj->fij", jc.view(-1, nf, 9), jc.view(-1, nf, 9))
    np.testing.assert_allclose(derivs.matE.numpy(), matE.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.matF.numpy(), matF.numpy(), atol=1e-9)
    np.testing.assert_allclose(derivs.matG.numpy(), matG.numpy(), atol=1e-9)


# ------------------------------------------------------------ triangulate

@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_triangulate_matches_jax(masked, monkeypatch):
    x, _, K, R, t = _problem(8, 10)
    x_fp = np.ascontiguousarray(x.transpose(1, 0, 2))  # (F, P, 2)
    vis = _mask(x.shape[:2]) if masked else None
    want = j_triangulate(*(jnp.asarray(a) for a in (x_fp, K, R, t)),
                         visibility=None if vis is None else jnp.asarray(vis))
    args = [torch.from_numpy(a) for a in (x_fp, K, R, t)]
    t_vis = None if vis is None else torch.from_numpy(vis)
    got = t_triangulate(*args, visibility=t_vis)
    _close(got, want, 1e-8)
    # the eigensolves run in slices of points; a ragged split changes nothing
    monkeypatch.setattr(tlin, "EIGH_BATCH", 64)
    assert torch.equal(t_triangulate(*args, visibility=t_vis), got)


def test_triangulate_takes_numpy():
    """numpy x, K, R, t and visibility give on the CPU, when asked for it,
    what CPU tensors give."""
    x, _, K, R, t = _problem(8, 10)
    x_fp = np.ascontiguousarray(x.transpose(1, 0, 2))
    vis = _mask(x.shape[:2])
    want = t_triangulate(*(torch.from_numpy(a) for a in (x_fp, K, R, t)),
                         visibility=torch.from_numpy(vis))
    got = t_triangulate(x_fp, K, R, t, visibility=vis, device="cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, want)


def test_nan_observation_rejects_every_step_and_keeps_the_state():
    """One unmasked NaN observation: E is NaN, every trial is rejected and
    the state stays at its finite start, as in the JAX package."""
    x, X0, K, R, t0 = _problem(6, 10)
    x = x.copy()
    x[3, 2, 0] = np.nan
    fields = dict(scale_factor=2.0, delta_tol=1e-10, max_iter=5)
    want = jba.bundle_adjust(*(jnp.asarray(a) for a in (x, X0, K, R, t0)), axis=AXIS,
                             config=JLMConfig(**fields))
    got = tba.bundle_adjust(x, X0, K, R, t0, axis=AXIS, config=LMConfig(**fields), device="cpu")
    assert np.isnan(float(got.error)) and np.isnan(float(want.error))
    for name in ("X", "R", "t", "K"):
        g = getattr(got, name).numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), atol=1e-9)
    np.testing.assert_allclose(got.X.numpy(), X0, atol=1e-9)
