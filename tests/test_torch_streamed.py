"""Parity of the port's host-streamed bundle adjustment with the JAX
package on the CPU, on the same numpy inputs:

- the per-chunk blocks (``_camera_param_derivs``, ``_chunk_factors``,
  ``_chunk_blocks``, which the port keeps in its dense module) and one chunk through ``_accumulate_chunk`` ->
  ``_assemble_and_solve`` -> ``_chunk_backsub`` (which the port keeps in its
  dense module), in float64 to 1e-10;
- ``bundle_adjust_streamed`` against JAX's in float64 (aligned and ragged
  chunks, with and without a mask; the segmented resume; the prefetch
  depth);
- the streamed core in float32 against JAX's float32 chunked core.
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
from mvrecon_tpu.models import bundle_adjustment_streamed as jbs
from mvrecon_tpu_torch.interop import ba_state_from_numpy, lm_config_from_fields, results_to_numpy
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models import bundle_adjustment_streamed as tbs

AXIS = "x-up_z-forward"


def _problem(seed=5, nf=12, n_slices=10, dtype=np.float64):
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


# ---------------------------------------------------------------- blocks

def _chunk(visibility):
    """One 64-point chunk in the normalized gauge, float64: the camera
    state as both packages' BAState, X_c, x_c, vis_c and the gauge mask."""
    x, X0, K, R, t0 = _problem()
    Xn, Rn, tn, _ = jba.normalize_gauge(jnp.asarray(X0), jnp.asarray(R), jnp.asarray(t0), AXIS)
    f, u = jba.intrinsics_from_K(jnp.asarray(K), 1.0)
    nf = K.shape[0]
    pb = {
        "X": np.array(Xn[:64]), "x": x[:64],
        "vis": _mask((64, nf)) if visibility else np.ones((64, 1)),
        "free": np.array(jba.gauge_mask(nf, AXIS, jnp.float64)),
    }
    cams = [np.zeros((0, 3))] + [np.array(a) for a in (f, u, tn, Rn)]
    jcam = jba.BAState(*(jnp.asarray(a) for a in cams))
    tcam = ba_state_from_numpy(*cams, "cpu", torch.float64)
    return jcam, tcam, pb


def _j(pb, *keys):
    return [jnp.asarray(pb[k]) for k in keys]


def _t(pb, *keys):
    return [torch.from_numpy(pb[k]) for k in keys]


def _close(got, want, tol=1e-10):
    """Same float64 algebra, summed in another order: to 1e-10 of the
    largest entry."""
    w = np.asarray(want)
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(np.abs(w).max(), 1e-300))


def test_camera_param_derivs_match_jax():
    jcam, tcam, pb = _chunk(False)
    jst = jcam._replace(X=jnp.asarray(pb["X"]))
    tst = tcam._replace(X=torch.from_numpy(pb["X"]))
    K = jba.build_K(jst.f, jst.u, 1.0)
    _, p, q, r = jba.calc_pqr(jst.X, K, jst.R, jst.t)
    want = jba._camera_param_derivs(jst, p, q, r, 1.0)
    got = tba._camera_param_derivs(tst, *(torch.from_numpy(np.array(a)) for a in (p, q, r)), 1.0)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("visibility", [False, True], ids=["full", "masked"])
def test_chunk_factors_and_blocks_match_jax(visibility):
    jcam, tcam, pb = _chunk(visibility)
    want = jbc._chunk_factors(jcam, *_j(pb, "X", "x", "vis"), 1.0)
    got = tba._chunk_factors(tcam, *_t(pb, "X", "x", "vis"), 1.0)
    for g, w in zip(got, want):
        _close(g, w)
    want = jbc._chunk_blocks(jcam, *_j(pb, "X", "x", "vis", "free"), 1.0)
    got = tba._chunk_blocks(tcam, *_t(pb, "X", "x", "vis", "free"), 1.0)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("visibility", [False, True], ids=["full", "masked"])
def test_one_chunk_accumulate_solve_backsub_matches_jax(visibility):
    jcam, tcam, pb = _chunk(visibility)
    nf = pb["free"].shape[0] // 9
    c = 3e-3

    shapes = ((9 * nf, 9 * nf), (9 * nf,), (nf, 9, 9), (9 * nf,), ())
    j_accs = jbs._accumulate_chunk(tuple(jnp.zeros(s) for s in shapes), jcam,
                                   *_j(pb, "X", "x", "vis", "free"), jnp.float64(c), 1.0)
    t_accs = tbs._accumulate_chunk(tuple(torch.zeros(s, dtype=torch.float64) for s in shapes),
                                   tcam, *_t(pb, "X", "x", "vis", "free"), c, 1.0)
    for g, w in zip(t_accs, j_accs):
        _close(g, w)
    j_dxi, _ = jbs._assemble_and_solve(j_accs, jnp.asarray(pb["free"]), jnp.float64(c), 1.0)
    t_dxi, _ = tbs._assemble_and_solve(t_accs, torch.from_numpy(pb["free"]), c)
    _close(t_dxi, j_dxi, tol=1e-8)  # a Cholesky solve: conditioning scales the rounding

    jtrial = jba._apply_update(jcam, j_dxi, jnp.zeros((0, 3)))
    ttrial = tba._apply_update(tcam, torch.from_numpy(np.array(j_dxi)), torch.zeros((0, 3)))
    want = jbs._backsub_chunk(jcam, jtrial, *_j(pb, "X", "x", "vis", "free"), jnp.float64(c),
                              j_dxi, 1.0)
    got = tba._chunk_backsub(tcam, ttrial, *_t(pb, "X", "x", "vis", "free"), c,
                             torch.from_numpy(np.array(j_dxi)), 1.0)[:2]
    for g, w in zip(got, want):
        _close(g, w)
    _close(tbs._chunk_error(tcam, *_t(pb, "X", "x", "vis"), 1.0),
           jbs._chunk_error(jcam, *_j(pb, "X", "x", "vis"), 1.0))


# ---------------------------------------------------------------- the core

def _run_both(prob, fields, chunk, visibility=None, **kw):
    jres = jbs.bundle_adjust_streamed(*prob, f0=1.0, visibility=visibility, axis=AXIS,
                                      config=JLMConfig(**fields), chunk_size=chunk, **kw)
    tres = tbs.bundle_adjust_streamed(*prob, f0=1.0, visibility=visibility, axis=AXIS,
                                      config=lm_config_from_fields(fields), chunk_size=chunk,
                                      device="cpu", **kw)
    return jres, results_to_numpy(tres)


STREAMED_CASES = {
    # 200 points: chunks of 50 are aligned, chunks of 48 leave a tail of 8
    "aligned": (50, False),
    "aligned-masked": (50, True),
    "ragged": (48, False),
    "ragged-masked": (48, True),
}


@pytest.mark.parametrize("case", list(STREAMED_CASES))
def test_streamed_float64_matches_jax(case):
    """Same algebra and protocol in float64: E to 1e-9 relative, the same
    iterations and retries, X, K and R to 1e-8."""
    chunk, masked = STREAMED_CASES[case]
    prob = _problem()
    vis = _mask(prob[0].shape[:2]) if masked else None
    fields = dict(scale_factor=2.0, delta_tol=1e-10, max_iter=5)
    jres, tres = _run_both(prob, fields, chunk, vis)
    np.testing.assert_allclose(float(tres["error"]), float(jres.error), rtol=1e-9)
    assert tres["n_iter"] == int(jres.n_iter)
    assert tres["log"]["n_solver_retries"] == int(jres.log["n_solver_retries"])
    for k in ("X", "K", "R"):
        np.testing.assert_allclose(tres[k], np.asarray(getattr(jres, k)), atol=1e-8)


def test_streamed_segmented_resume_matches_continuous():
    """3 + 3 iterations with the state and c carried through ``init_c``
    equal one 6-iteration run of the port and of the JAX package: the
    same float64 arithmetic, up to the gauge restore/re-normalize round
    trip between the segments (E to 1e-9, X to 1e-8)."""
    prob = _problem(seed=2)
    fields3 = dict(scale_factor=2.0, delta_tol=0.0, max_iter=3)
    cfg3 = lm_config_from_fields(fields3)
    jfull, full = _run_both(prob, dict(fields3, max_iter=6), 64)
    p1 = tbs.bundle_adjust_streamed(*prob, axis=AXIS, config=cfg3, chunk_size=64, device="cpu")
    p2 = tbs.bundle_adjust_streamed(prob[0], p1.X, p1.K, p1.R, p1.t, axis=AXIS, config=cfg3,
                                    chunk_size=64, init_c=p1.log["c"], device="cpu")
    for want in (full["error"], float(jfull.error)):
        np.testing.assert_allclose(float(p2.error), want, rtol=1e-9)
    np.testing.assert_allclose(p2.X.numpy(), full["X"], atol=1e-8)
    np.testing.assert_allclose(p2.X.numpy(), np.asarray(jfull.X), atol=1e-8)
    assert p1.n_iter + p2.n_iter == full["n_iter"] == int(jfull.n_iter)


def test_streamed_prefetch_matches_serial():
    """The prefetch depth schedules copies only: bit-identical results."""
    prob = _problem(seed=3, nf=6)
    cfg = lm_config_from_fields(dict(scale_factor=2.0, delta_tol=0.0, max_iter=4))
    runs = [tbs.bundle_adjust_streamed(*prob, axis=AXIS, config=cfg, chunk_size=64,
                                       prefetch=depth, device="cpu") for depth in (0, 2)]
    assert float(runs[0].error) == float(runs[1].error)
    np.testing.assert_array_equal(runs[0].X.numpy(), runs[1].X.numpy())


def test_streamed_float32_matches_jax_chunked_float32():
    """float32: the port's streamed core (float64-summed SYRK plain
    version) against JAX's float32 chunked core, whose CPU default is the
    same non-fused algebra with HIGHEST einsums. Both lose ~1e-7 relative
    per sum, and three iterations keep the LM trajectory on one branch:
    E to 1e-4 and the same iteration count."""
    prob = _problem(seed=7, dtype=np.float32)
    fields = dict(scale_factor=2.0, delta_tol=0.0, max_iter=3)
    jres = jbc.bundle_adjust_chunked(*(jnp.asarray(a) for a in prob), f0=1.0, axis=AXIS,
                                     config=JLMConfig(**fields), chunk_size=64)
    assert jres.X.dtype == jnp.float32
    tres = tbs.bundle_adjust_streamed(*prob, f0=1.0, axis=AXIS,
                                      config=lm_config_from_fields(fields), chunk_size=64,
                                      device="cpu")
    assert tres.error.dtype == torch.float32
    np.testing.assert_allclose(float(tres.error), float(jres.error), rtol=1e-4)
    assert tres.n_iter == int(jres.n_iter)


@pytest.mark.parametrize("change", [dict(distortion_rounds=1, distortion_model=m)
                                    for m in ("fisheye", "full_opencv", "fov", "thin_prism")])
def test_streamed_unported_options_raise(change):
    """The distortion families of the second slice, which raised here
    before, run refit from their default start as JAX's streamed core
    does: the same E (rtol 1e-8), iterations, retries and distortion."""
    prob = _problem(nf=6, n_slices=2)
    fields = dict(scale_factor=2.0, delta_tol=0.0, max_iter=2, **change)
    want = jbs.bundle_adjust_streamed(*prob, axis=AXIS, config=JLMConfig(**fields),
                                      chunk_size=16)
    got = tbs.bundle_adjust_streamed(*prob, axis=AXIS, config=lm_config_from_fields(fields),
                                     chunk_size=16, device="cpu")
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-8)
    assert got.n_iter == int(want.n_iter)
    assert got.log["n_solver_retries"] == int(want.log["n_solver_retries"])
    w = np.asarray(want.distortion)
    np.testing.assert_allclose(got.distortion.numpy(), w, rtol=0,
                               atol=1e-8 * max(1.0, float(np.abs(w).max())))


def _every_core(prob):
    """Run one problem through the dense, chunked and streamed cores."""
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked

    return {
        "dense": lambda cfg: tba.bundle_adjust(*prob, axis=AXIS, config=cfg, device="cpu"),
        "chunked": lambda cfg: bundle_adjust_chunked(*prob, axis=AXIS, config=cfg,
                                                     chunk_size=16, device="cpu"),
        "streamed": lambda cfg: tbs.bundle_adjust_streamed(*prob, axis=AXIS, config=cfg,
                                                           chunk_size=16, device="cpu"),
    }


@pytest.mark.parametrize("spelling", ["", "none"])
def test_plain_loss_spellings_equal_none_on_every_core(spelling):
    """None, "" and "none" all mean plain least squares, as JAX's
    ``resolve_robust`` has it, on each of the three cores."""
    fields = dict(scale_factor=2.0, delta_tol=0.0, max_iter=2)
    for core, run in _every_core(_problem(nf=6, n_slices=2)).items():
        plain = run(lm_config_from_fields(fields))
        spelled = run(lm_config_from_fields({**fields, "robust": spelling}))
        assert float(spelled.error) == float(plain.error), core
        assert spelled.n_iter == plain.n_iter, core


def test_unknown_loss_raises_value_error_on_every_core():
    with pytest.raises(ValueError, match="unknown robust loss"):
        jba.resolve_robust("bogus")
    for core, run in _every_core(_problem(nf=6, n_slices=2)).items():
        with pytest.raises(ValueError, match="unknown robust loss"):
            run(lm_config_from_fields({"robust": "bogus"}))
