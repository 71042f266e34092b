"""The port's sparse observation-list BA core
(``mvrecon_tpu_torch/models/bundle_adjustment_sparse.py``) held against
the JAX package's on the CPU, on the same numpy inputs: the curved tube in
8 views x 200 points at 60 % random visibility, X and t perturbed by
0.02 N(0, 1), as in JAX's ``tests/test_ba_sparse.py``.

- ``make_sparse_obs`` and ``dense_to_sparse_obs``: exact;
- one damped build (d_P, the point blocks, d_F, the rhs, the camera
  blocks, the preconditioner) and one Schur matvec, float64, to 1e-10 of
  the largest entry; one PCG solve on that system takes JAX's count at
  three tolerances; both segment-sum forms agree;
- ``bundle_adjust_sparse`` in float64 at ``cg_tol=1e-12``, 3 iterations,
  for the plain loss, the reference schedule, the four robust losses (2 %
  of the observations moved by 0.3), one refit round of the radial model
  and each fixed family: E to rtol 1e-8, X to atol 1e-7, the same
  iterations and retries, the CG total within ``CG_BAND``. Near 1e-12 the
  float64 PCG residual of these systems hovers for several iterations, so
  the count moves with the summation order: JAX's own core counts 97 or
  95 (huber) and 100 or 102 (fixed FOV) when only its ``obs_chunk``
  changes (65,536 or 256), and the port's differ from JAX's by at most 4
  of 100-152, while E agrees to 1e-13.
- recompute against stored, ``matvec_chunk`` against none, zero-weight
  padding invisible, bfloat16 factors below the start E, and the
  ``record_log`` curve against the dense core's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu.models import bundle_adjustment_sparse as jbs
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import sparse_obs_from_numpy
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models import bundle_adjustment_sparse as tbs

AXIS = "x-up_z-forward"
CFG = dict(scale_factor=4.0, delta_tol=0.0, max_iter=3, accept_divisor=1.0,
           init_damping=3e-3, damping="nielsen")
CG_BAND = 0.05  # relative band of the CG total (see the module docstring)
FAMILIES = {"radial": 2, "opencv": 4, "fisheye": 4, "full_opencv": 8, "fov": 1,
            "thin_prism": 8}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n_images=8, n_slices=10, vis_frac=0.6, seed=0, noise=0.02, outliers=False):
    key = jax.random.key(seed)
    sc = make_synthetic_scene(key, n_images=n_images, n_slices=n_slices, n_angles=20,
                              dtype=jnp.float64)
    k1, k2 = jax.random.split(key)
    X0 = np.asarray(sc.X + noise * jax.random.normal(k1, sc.X.shape, dtype=jnp.float64))
    t0 = np.asarray(sc.t + noise * jax.random.normal(k2, sc.t.shape, dtype=jnp.float64))
    x = np.array(sc.x.transpose(1, 0, 2))
    rng = np.random.default_rng(seed)
    vis = (rng.random(x.shape[:2]) < vis_frac).astype(np.float64)
    if outliers:
        pi, ci = np.nonzero(vis > 0)
        sel = np.random.default_rng(3).choice(len(pi), size=len(pi) // 50, replace=False)
        x[pi[sel], ci[sel]] += 0.3
    return x, vis, X0, np.asarray(sc.K), np.asarray(sc.R), t0


PROBLEM = _problem()


def _obs_pair(x, vis):
    jo = jbs.dense_to_sparse_obs(x, vis)
    to = sparse_obs_from_numpy(*(np.asarray(a) for a in jo), device="cpu",
                               dtype=torch.float64)
    return jo, to


def _dist(model, nf):
    if model == "fov":
        return np.full((nf, 1), 0.4)
    return 0.01 * np.random.default_rng(7).standard_normal((nf, FAMILIES[model]))


CASES = {
    "plain": ({}, False, None),
    "reference": (dict(scale_factor=2.0, delta_tol=1e-10, max_iter=3, accept_divisor=None,
                       init_damping=1e-4, damping="reference"), False, None),
    **{loss: (dict(robust=loss, huber_delta=0.02), True, None)
       for loss in ("huber", "cauchy", "soft_l1", "arctan")},
    "radial_refit": (dict(distortion_rounds=1, max_iter=2), False, None),
    **{f"fixed_{m}": (dict(distortion_model=m), False, m) for m in FAMILIES},
}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's bundle_adjust_sparse for each case, computed once."""
    out = {}
    for name, (fields, outliers, model) in CASES.items():
        x, vis, X0, K, R, t0 = _problem(outliers=outliers)
        dist = None if model is None else _dist(model, K.shape[0])
        cfg = JLMConfig(**{**CFG, **fields})
        jo = jbs.dense_to_sparse_obs(x, vis)
        r = jbs.bundle_adjust_sparse(jo, X0, K, R, t0, f0=1.0, axis=AXIS, config=cfg,
                                     cg_tol=1e-12, cg_max_iter=500,
                                     distortion=None if dist is None else jnp.asarray(dist))
        out[name] = {"E": float(r.error), "n_iter": int(r.n_iter), "X": np.asarray(r.X),
                     "cg": int(r.log["cg_iters_total"]),
                     "retries": int(r.log["n_solver_retries"]),
                     "dist": None if r.distortion is None else np.asarray(r.distortion)}
    return out


def test_make_sparse_obs_matches_jax():
    pi = np.array([3, 0, 2, 0, 3])
    ci = np.array([1, 2, 0, 1, 0])
    xy = np.arange(10.0).reshape(5, 2)
    j = jbs.make_sparse_obs(pi, ci, xy)
    t = tbs.make_sparse_obs(pi, ci, xy, device="cpu")
    assert t.point_idx.dtype == torch.int32 and t.xy.shape == (2, 5)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # (2, N) input is taken as such
    t2 = tbs.make_sparse_obs(pi, ci, xy.T, device="cpu")
    np.testing.assert_array_equal(t2.xy.numpy(), t.xy.numpy())
    with pytest.raises(ValueError, match="inconsistent"):
        tbs.make_sparse_obs(pi, ci[:4], xy, device="cpu")


def test_dense_to_sparse_obs_matches_jax():
    x, vis = PROBLEM[0], PROBLEM[1].copy()
    vis[vis > 0] *= 0.5 + np.random.default_rng(2).random(int((vis > 0).sum()))
    j = jbs.dense_to_sparse_obs(x, vis)
    t = tbs.dense_to_sparse_obs(x, vis, device="cpu")
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _build_pair(c=3e-3, huber=None, seed=1):
    """JAX's ``_build_sparse_system`` and the port's point and camera sides
    on one state, with one random camera vector."""
    x, vis, X0, K, R, t0 = PROBLEM
    X0n, R0n, t0n, _ = jba.normalize_gauge(X0, R, t0, AXIS)
    f, u = jba.intrinsics_from_K(K, 1.0)
    nf = K.shape[0]
    free = jba.gauge_mask(nf, AXIS, jnp.float64)
    jo, to = _obs_pair(x, vis)
    jcam = jba.BAState(X=jnp.zeros((0, 3)), f=f, u=u, t=t0n, R=R0n)
    out = jbs._build_sparse_system(jcam, tuple(X0n[:, i] for i in range(3)), jo, free, 1.0, c,
                                   huber, None, None, "huber", 1 << 16)
    T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    tcam = tba.BAState(X=torch.zeros((0, 3), dtype=torch.float64), f=T(f), u=T(u), t=T(t0n),
                       R=T(R0n))
    pl = tbs._plan(to, nf, to.n_obs)
    pb = tbs._Problem(to, X0.shape[0], nf, 1.0, pl, tbs._plan(to, nf, 97), pl, huber, "huber",
                      None, False, None, None)
    st = tbs._state_of(pb, tcam, T(X0n).T.contiguous(), None)
    ps = tbs._point_side(pb, st)
    sy = tbs._camera_side(pb, st, ps, T(free), torch.tensor(c, dtype=torch.float64))
    v = np.random.default_rng(seed).standard_normal(9 * nf)
    return out, (jo, free, v), (pb, st, ps, sy, T(free), T(v))


def _close(a, b, rtol):
    a, b = np.asarray(a), b.numpy()
    assert np.abs(a - b).max() <= rtol * np.abs(a).max()


@pytest.mark.parametrize("huber", [None, 0.02], ids=["plain", "huber"])
def test_build_and_matvec_match_jax(huber):
    out, (jo, free, v), (pb, st, ps, sy, tfree, tv) = _build_pair(huber=huber)
    factors, matGc, m_inv, rhs, d_F, diag_g, e_now, matE6, seen_c = out
    _close(e_now, ps.e_w, 1e-12)
    _close(np.stack(factors[6]), ps.d_P, 1e-10)
    _close(np.stack(matE6), ps.matE6, 1e-10)
    _close(matGc, sy.matGc, 1e-10)
    _close(m_inv, sy.m_inv, 1e-10)
    _close(rhs, sy.rhs, 1e-10)
    _close(d_F, sy.d_F, 1e-10)
    _close(diag_g, sy.diag_g, 1e-10)
    _close(seen_c, sy.seen_c, 0)
    sv = jbs._schur_matvec(jnp.asarray(v), factors, matGc, jo, free, seen_c)
    _close(sv, tbs._schur_matvec(pb, st, sy, tfree, tv), 1e-10)
    # one PCG solve on the same system takes JAX's count
    nf = matGc.shape[0]
    for tol in (1e-6, 1e-9, 1e-12):
        xj, nj = jbs._pcg(lambda q: jbs._schur_matvec(q, factors, matGc, jo, free, seen_c),
                          lambda q: jnp.einsum("fij,fj->fi", m_inv, q.reshape(nf, 9)).reshape(-1),
                          rhs, tol, 500, jnp.float64, x0=jnp.zeros_like(rhs))
        xt, nt = tbs._pcg(lambda q: tbs._schur_matvec(pb, st, sy, tfree, q),
                          lambda q: torch.einsum("fij,fj->fi", sy.m_inv,
                                                 q.view(nf, 9)).reshape(-1), sy.rhs, tol, 500)
        assert nt == int(nj), tol
        _close(xj, xt, 1e-9)


def test_segment_sum_forms_agree(monkeypatch):
    """The one-call and the row-by-row segment sums give the same matvec."""
    _, _, (pb, st, ps, sy, tfree, tv) = _build_pair()
    want = tbs._schur_matvec(pb, st, sy, tfree, tv)
    monkeypatch.setattr(tbs, "_LONG_SEGMENT", 0)
    got = tbs._schur_matvec(pb, st, sy, tfree, tv)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", list(CASES))
def test_bundle_adjust_sparse_matches_jax(jax_runs, name):
    fields, outliers, model = CASES[name]
    x, vis, X0, K, R, t0 = _problem(outliers=outliers)
    dist = None if model is None else _dist(model, K.shape[0])
    _, to = _obs_pair(x, vis)
    r = tbs.bundle_adjust_sparse(to, X0, K, R, t0, f0=1.0, axis=AXIS,
                                 config=LMConfig(**{**CFG, **fields}), cg_tol=1e-12,
                                 cg_max_iter=500, distortion=dist, device="cpu")
    want = jax_runs[name]
    assert float(r.error) == pytest.approx(want["E"], rel=1e-8)
    np.testing.assert_allclose(r.X.numpy(), want["X"], atol=1e-7)
    assert (r.n_iter, r.log["n_solver_retries"]) == (want["n_iter"], want["retries"])
    assert abs(r.log["cg_iters_total"] - want["cg"]) <= max(2, CG_BAND * want["cg"])
    if want["dist"] is not None:
        np.testing.assert_allclose(r.distortion.numpy(), want["dist"],
                                   atol=1e-8 * max(1.0, np.abs(want["dist"]).max()))


def _run(obs, config=LMConfig(**CFG), **kw):
    x, vis, X0, K, R, t0 = PROBLEM
    return tbs.bundle_adjust_sparse(obs, X0, K, R, t0, f0=1.0, axis=AXIS, config=config,
                                    device="cpu", **kw)


def test_recompute_and_matvec_chunk_match_stored():
    _, to = _obs_pair(*PROBLEM[:2])
    kw = dict(cg_tol=1e-12, cg_max_iter=500)
    a = _run(to, **kw)
    for extra in (dict(factor_mode="recompute", obs_chunk=311),
                  dict(factor_mode="recompute", obs_chunk=311, matvec_chunk=129),
                  dict(matvec_chunk=257)):
        b = _run(to, **kw, **extra)
        assert float(b.error) == pytest.approx(float(a.error), rel=1e-10), extra
        torch.testing.assert_close(b.X, a.X, rtol=0, atol=1e-8)
        assert b.n_iter == a.n_iter


def test_recompute_robust_distortion_matches_stored():
    _, to = _obs_pair(*PROBLEM[:2])
    nf = PROBLEM[3].shape[0]
    cfg = LMConfig(**{**CFG, "robust": "huber", "huber_delta": 0.05})
    kw = dict(config=cfg, cg_tol=1e-12, cg_max_iter=500,
              distortion=np.tile([[-0.05, 0.01]], (nf, 1)))
    a = _run(to, **kw)
    b = _run(to, factor_mode="recompute", obs_chunk=311, **kw)
    assert float(b.error) == pytest.approx(float(a.error), rel=1e-10)
    torch.testing.assert_close(b.X, a.X, rtol=0, atol=1e-8)


def test_zero_weight_padding_is_invisible():
    x, vis, X0, K, R, t0 = PROBLEM
    _, to = _obs_pair(x, vis)
    npts, nf = X0.shape[0], K.shape[0]
    pad = 17
    padded = tbs.SparseObs(
        torch.cat([to.point_idx, torch.full((pad,), npts - 1, dtype=torch.int32)]),
        torch.cat([to.cam_idx, torch.full((pad,), nf - 1, dtype=torch.int32)]),
        torch.cat([to.xy, torch.full((2, pad), 1e6, dtype=torch.float64)], dim=1),
        torch.cat([to.weights, torch.zeros(pad, dtype=torch.float64)]))
    a, b = _run(to), _run(padded)
    assert float(b.error) == pytest.approx(float(a.error), rel=1e-12)
    torch.testing.assert_close(b.X, a.X, rtol=0, atol=1e-10)


def test_bf16_factors_converge():
    _, to = _obs_pair(*PROBLEM[:2])
    cfg = LMConfig(**{**CFG, "max_iter": 20, "record_log": True})
    a = _run(to.to("cpu", torch.float32), config=cfg, cg_tol=1e-2, cg_max_iter=50,
             factor_dtype="bfloat16")
    e = a.log["reprojection_error"]
    assert torch.isfinite(a.error) and float(a.error) < float(e[0])
    ref = _run(to, config=cfg, cg_tol=1e-10, cg_max_iter=500)
    assert float(a.error) <= 1.05 * float(ref.error)
    assert a.X.dtype == torch.float32


def test_record_log_matches_dense_curve():
    x, vis, X0, K, R, t0 = PROBLEM
    _, to = _obs_pair(x, vis)
    cfg = LMConfig(**{**CFG, "record_log": True})
    s = _run(to, config=cfg, cg_tol=1e-12, cg_max_iter=500)
    d = tba.bundle_adjust(x, X0, K, R, t0, f0=1.0, visibility=vis, axis=AXIS, config=cfg,
                          device="cpu")
    assert s.n_iter == d.n_iter
    n = s.n_iter + 1
    np.testing.assert_allclose(s.log["reprojection_error"][:n].numpy(),
                               d.log["reprojection_error"][:n].numpy(), rtol=1e-9)
    assert float(s.log["reprojection_error"][n - 1]) == pytest.approx(float(s.error))
    assert s.log["converged"] is False
