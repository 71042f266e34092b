"""The port's reference-API layer and its helpers against the JAX package,
in float64 on the CPU, on the same numpy inputs:

- the four public signatures aligned with JAX's: ``lm_step`` (a distorted
  step too), ``fit_distortion``, ``fit_distortion_chunked`` and
  ``ba_covariance_streamed``, each in JAX's keyword and positional forms,
  to 1e-8 (``ba_covariance_streamed``'s float32 default: its sigma^2 and
  E to 1e-5 of JAX's float32);
- ``runtime/logging.py`` on equal logs: records, curves, the formatted
  text and the JSON lines, exactly;
- the shims ``camera``, ``utils``, ``factorization``,
  ``affine_camera_calibration`` (through ``aligned_rmse``: the SVD keeps
  each backend's signs), ``perspective_camera_calibration``,
  ``minimum_spanning_tree`` (ties included, on the native route) and
  ``BundleAdjuster`` (its log against JAX's, and its chunked dispatch
  against its dense log), with the helpers only they reach; 1e-12 for
  closed forms, 1e-8 through an iteration;
- the public names of every compat module and of the ``ops``,
  ``geometry`` and ``models`` packages against JAX's, on the AST;
- the plotting layer under matplotlib's Agg backend, and an import of the
  whole port with matplotlib absent.
"""

import ast
import functools
import json
import os
import pathlib
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mvrecon_tpu
from mvrecon_tpu import bundle_adjustment as j_ba_shim
from mvrecon_tpu import camera as j_camera
from mvrecon_tpu import factorization as j_factorization
from mvrecon_tpu import minimum_spanning_tree as j_mst
from mvrecon_tpu import perspective_camera_calibration as j_persp
from mvrecon_tpu import affine_camera_calibration as j_affine
from mvrecon_tpu import utils as j_utils
from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu.models import bundle_adjustment_chunked as jbc
from mvrecon_tpu.models import covariance as jcov
from mvrecon_tpu.models import perspective as jpersp_core
from mvrecon_tpu.ops import linalg as jlin
from mvrecon_tpu.ops import rotations as jrot
from mvrecon_tpu.runtime import logging as jlog
import mvrecon_tpu_torch
from mvrecon_tpu_torch import affine_camera_calibration as t_affine
from mvrecon_tpu_torch import bundle_adjustment as t_ba_shim
from mvrecon_tpu_torch import camera as t_camera
from mvrecon_tpu_torch import factorization as t_factorization
from mvrecon_tpu_torch import minimum_spanning_tree as t_mst
from mvrecon_tpu_torch import perspective_camera_calibration as t_persp
from mvrecon_tpu_torch import utils as t_utils
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.geometry.scenes import add_noise
from mvrecon_tpu_torch.interop import ba_state_from_numpy
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models import bundle_adjustment_chunked as tbc
from mvrecon_tpu_torch.models import covariance as tcov
from mvrecon_tpu_torch.models import perspective as tpersp_core
from mvrecon_tpu_torch.ops import linalg as tlin
from mvrecon_tpu_torch.ops import procrustes as tpro
from mvrecon_tpu_torch.ops import rotations as trot
from mvrecon_tpu_torch.runtime import logging as tlog
from mvrecon_tpu_torch.runtime.native import mst_native

AXIS = "x-up_z-forward"
JAX_ROOT = pathlib.Path(mvrecon_tpu.__file__).parent
PORT_ROOT = pathlib.Path(mvrecon_tpu_torch.__file__).parent
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, want, tol):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=tol, atol=tol * max(np.abs(w).max(), 1.0))


@pytest.fixture(scope="module")
def scene():
    """The reference demo's scene, 10 views x 200 points, as numpy:
    (x (F, P, 2), X, K, R, t)."""
    sc = make_synthetic_scene(jax.random.key(5), n_images=10, dtype=jnp.float64)
    return tuple(np.array(a) for a in (sc.x, sc.X, sc.K, sc.R, sc.t))


@pytest.fixture(scope="module")
def problem(scene):
    """A small distorted BA problem, 40 points x 5 views of ``scene``:
    x (P, F, 2), a radial model around (-0.1, 0.02), a start with X and t
    moved by 0.01 N(0, 1), and a visibility mask."""
    x, X, K, R, t = scene
    rng = np.random.default_rng(2)
    X0 = X[::5] + 0.01 * rng.standard_normal((40, 3))
    t0 = t[:5] + 0.01 * rng.standard_normal((5, 3))
    dist = np.array([-0.1, 0.02]) * (1 + 0.1 * rng.standard_normal((5, 2)))
    vis = (rng.uniform(size=(40, 5)) > 0.1).astype(np.float64)
    return x[:5, ::5].transpose(1, 0, 2).copy(), X0, K[:5], R[:5], t0, dist, vis


def _states(problem):
    x, X0, K, R, t0, _, _ = problem
    jstate = jba.BAState(X=jnp.asarray(X0), f=jnp.asarray(K[:, 0, 0]),
                         u=jnp.asarray(K[:, :2, 2]), t=jnp.asarray(t0), R=jnp.asarray(R))
    return jstate, ba_state_from_numpy(X0, K[:, 0, 0], K[:, :2, 2], t0, R, "cpu", torch.float64)


# ------------------------------------------------------------ F14

@pytest.mark.parametrize("form", ["keyword", "positional"])
def test_lm_step_signature_matches_jax(problem, form):
    """A distorted LM step through JAX's argument names and positions
    equals JAX's; the pinhole step too; an ``axis_name`` that no sharded
    call binds raises ``ValueError``."""
    x, _, _, _, _, dist, vis = problem
    jstate, tstate = _states(problem)
    free_np = np.array(jba.gauge_mask(5, AXIS, jnp.float64))
    c = 1e-3
    jargs = (jnp.asarray(x), jstate, jnp.asarray(vis), jnp.asarray(free_np), 1.0,
             jnp.asarray(c))
    targs = (torch.from_numpy(x), tstate, torch.from_numpy(vis), torch.from_numpy(free_np), 1.0,
             torch.tensor(c, dtype=torch.float64))
    j_step = jax.jit(jba.lm_step, static_argnums=(4, 6, 8))  # one compile per model
    errors = []
    for d in (dist, None):
        jd = None if d is None else jnp.asarray(d)
        td = None if d is None else torch.from_numpy(d)
        want = j_step(*jargs, None, jd, "auto")
        if form == "keyword":
            got = tba.lm_step(*targs, dist=td, distortion_model="auto")
        else:
            got = tba.lm_step(*targs, None, td, "auto")
        for g, w in zip(got[0], want[0]):
            _close(g, w, 1e-8)
        _close(got[1], want[1], 1e-8)
        _close(got[2], want[2], 1e-8)
        errors.append(float(got[1]))
    assert errors[0] != pytest.approx(errors[1], rel=1e-3)  # the model was applied
    with pytest.raises(ValueError, match="not bound"):
        tba.lm_step(*targs, "points")


@pytest.mark.parametrize("form", ["keyword", "positional"])
def test_fit_distortion_signatures_match_jax(problem, form):
    """``fit_distortion`` with JAX's ``axis_name`` slot before
    ``tangential``, and ``fit_distortion_chunked`` with ``tangential``:
    the OPENCV refit of both equals JAX's."""
    x, _, _, _, _, _, vis = problem
    jstate, tstate = _states(problem)
    jx, jv, tx, tv = jnp.asarray(x), jnp.asarray(vis), torch.from_numpy(x), torch.from_numpy(vis)
    if form == "keyword":
        want = jba.fit_distortion(jstate, jx, jv, 1.0, shared=False, axis_name=None,
                                  tangential=True)
        got = tba.fit_distortion(tstate, tx, tv, 1.0, shared=False, axis_name=None,
                                 tangential=True)
        want_c = jbc.fit_distortion_chunked(jstate, jx, jv, 1.0, 16, tangential=True)
        got_c = tbc.fit_distortion_chunked(tstate, tx, tv, 1.0, 16, tangential=True)
    else:
        want = jba.fit_distortion(jstate, jx, jv, 1.0, False, None, True)
        got = tba.fit_distortion(tstate, tx, tv, 1.0, False, None, True)
        want_c = jbc.fit_distortion_chunked(jstate, jx, jv, 1.0, 16, False, None, None, None,
                                            True)
        got_c = tbc.fit_distortion_chunked(tstate, tx, tv, 1.0, 16, False, None, None, None,
                                           True)
    assert got.shape == got_c.shape == (5, 4)
    _close(got, want, 1e-8)
    _close(got_c, want_c, 1e-8)
    with pytest.raises(ValueError, match="not bound"):
        tba.fit_distortion(tstate, tx, tv, 1.0, False, "points")
    with pytest.raises(ValueError, match="not bound"):
        tbc.fit_distortion_chunked(tstate, tx, tv, 1.0, 16, axis_name="points")


@pytest.mark.parametrize("form", ["keyword", "positional"])
def test_covariance_streamed_dtype_matches_jax(problem, form):
    """``ba_covariance_streamed`` computes in ``dtype``, float32 by default
    as in JAX, whatever the host array's dtype: the float64 blocks to 1e-8
    of JAX's float64; with the float32 default, sigma^2 and E to 1e-5 of
    JAX's float32 (the float32 blocks go through the inverse of a camera
    system whose condition number is near 1/eps of float32, ROADMAP F10,
    so they agree with neither side's float64)."""
    x, X0, K, R, t0, _, vis = problem
    res = tba.bundle_adjust(x, X0, K, R, t0, axis=AXIS, visibility=vis, device="cpu",
                            config=LMConfig(scale_factor=2.0, delta_tol=1e-12, max_iter=10))
    sol = tuple(_np(a) for a in res[:4])
    for jdt, tdt, tol in ((jnp.float64, torch.float64, 1e-8), (None, None, 1e-5)):
        jkw = {} if jdt is None else {"dtype": jdt}
        tkw = {} if tdt is None else {"dtype": tdt}
        if form == "keyword":
            want = jcov.ba_covariance_streamed(x, *sol, visibility=vis, axis=AXIS, chunk_size=64,
                                               **jkw)
            got = tcov.ba_covariance_streamed(x, *sol, visibility=vis, axis=AXIS, chunk_size=64,
                                              **tkw, **CPU)
        else:
            want = jcov.ba_covariance_streamed(x, *sol, 1.0, vis, AXIS, JLMConfig(), None, 64, 2,
                                               *jkw.values())
            got = tcov.ba_covariance_streamed(x, *sol, 1.0, vis, AXIS, LMConfig(), None, 64, 2,
                                              *tkw.values(), **CPU)
        assert got.point_cov.dtype == (tdt or torch.float32)
        keys = ("point_cov", "camera_cov", "sigma2") if tdt else ("sigma2", "error")
        for k in keys:
            _close(getattr(got, k), getattr(want, k), tol)


# ------------------------------------------------------------ logging

def _random_log(n_rows=6, npts=7, nf=3):
    rng = np.random.default_rng(4)
    return {"points": rng.standard_normal((n_rows, npts, 3)),
            "basis": rng.standard_normal((n_rows, nf, 3, 3)),
            "pos": rng.standard_normal((n_rows, nf, 3)),
            "reprojection_error": np.sort(rng.uniform(size=n_rows))[::-1].copy()}


def test_logging_matches_jax(tmp_path):
    """Records, curves, text and JSON lines from equal logs (the port's as
    tensors, JAX's as numpy) are equal, for every iteration count."""
    log = _random_log()
    tlog_in = {k: torch.from_numpy(v) for k, v in log.items()}
    for n_iter in (0, 3, 5):
        want = jlog.device_log_to_records(log, n_iter)
        got = tlog.device_log_to_records(tlog_in, n_iter)
        assert len(got) == len(want) == n_iter + 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in ("points", "basis", "pos"):
                np.testing.assert_array_equal(g[k], w[k])
            assert g["reprojection_error"] == w["reprojection_error"]
            assert type(g["reprojection_error"]) is float
        assert (tlog.scalar_log_to_records(tlog_in, n_iter)
                == jlog.scalar_log_to_records(log, n_iter))
        np.testing.assert_array_equal(tlog.convergence_curve(tlog_in, n_iter),
                                      jlog.convergence_curve(log, n_iter))
        assert tlog.format_convergence(tlog_in, n_iter) == jlog.format_convergence(log, n_iter)
        tlog.dump_jsonl(str(tmp_path / "port.jsonl"), got)
        jlog.dump_jsonl(str(tmp_path / "jax.jsonl"), want)
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    json.dumps(tlog.scalar_log_to_records(tlog_in, 5))


# ------------------------------------------------------------ shims

def test_camera_shim_matches_jax():
    """``Camera`` (look-at constructor, matrix, both projections), the
    batch helpers and the reference's own camera self-test cases."""
    X = np.random.default_rng(0).normal(size=(20, 3))
    ours = t_camera.Camera.create((1.0, 2.0, -3.0), (0.1, -0.2, 0.3), f=1.2, f0=0.9, **CPU)
    theirs = j_camera.Camera.create((1.0, 2.0, -3.0), (0.1, -0.2, 0.3), f=1.2, f0=0.9)
    _close(ours.get_camera_matrix(), theirs.get_camera_matrix(), 1e-12)
    for method in ("perspective", "orthographic"):
        _close(ours.project_points(X, method=method), theirs.project_points(X, method=method),
               1e-12)
    with pytest.raises(ValueError):
        ours.project_points(X, method="fisheye")
    cams = [t_camera.Camera.create((0, 0, -1), (0, 0, 1), **CPU),
            t_camera.Camera.create((0, -1, 0), (0, 1, 0), **CPU)]
    Xs = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    np.testing.assert_array_almost_equal(_np(cams[0].project_points(Xs)),
                                         [[0, 0], [1, 0], [0, 1], [0, 0]])
    np.testing.assert_array_almost_equal(_np(cams[1].project_points(Xs)),
                                         [[0, 0], [1, 0], [0, 0], [0, -1]])
    K, R, t = t_camera.get_camera_parames(cams)
    jK, jR, jt = j_camera.get_camera_parames(
        [j_camera.Camera.create((0, 0, -1), (0, 0, 1)), j_camera.Camera.create((0, -1, 0),
                                                                               (0, 1, 0))])
    for g, w in ((K, jK), (R, jR), (t, jt)):
        _close(g, w, 1e-12)
    got = t_camera.calc_projected_points(X, K, R, t, **CPU)
    want = j_camera.calc_projected_points(X, jK, jR, jt)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_utils_shim_matches_jax():
    """The closed forms equal JAX's; the samplers draw the same numbers
    from NumPy's global random state."""
    omega = np.array([0.3, -1.2, 0.5])
    _close(t_utils.get_rotation_matrix(omega, **CPU), j_utils.get_rotation_matrix(omega), 1e-12)
    _close(t_utils.unit_vec(omega, **CPU), j_utils.unit_vec(omega), 1e-15)
    _close(t_utils.set_points(**CPU), j_utils.set_points(), 1e-12)
    X = np.ones((5, 3))
    for fn, args in (("sample_normal_dist", (0.3, 6)), ("add_noise", (X, 0.1)),
                     ("sample_hemisphere_points", (4, 5.0))):
        np.random.seed(11)
        want = getattr(j_utils, fn)(*args)
        np.random.seed(11)
        got = getattr(t_utils, fn)(*args, **CPU)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_factorization_shim_matches_jax():
    w = np.random.default_rng(1).normal(size=(24, 100))
    m, s = t_factorization.factorization_method(w, n_rank=3, **CPU)
    jm, js = j_factorization.factorization_method(w, n_rank=3)
    _close(m @ s, np.asarray(jm @ js), 1e-10)


@pytest.mark.parametrize("fn", ["orthographic_self_calibration",
                                "symmetric_affine_self_calibration",
                                "paraperspective_self_calibration"])
def test_affine_shim_accepts_a_list(scene, fn):
    """A list of (P, 2) arrays and the stacked array give one result, with
    JAX's shape up to a similarity (each backend keeps its SVD signs)."""
    x = scene[0]
    extra = (np.ones(10),) if fn.startswith("para") else ()
    S_l, R_l = getattr(t_affine, fn)([xi.copy() for xi in x], *extra, **CPU)
    S_a, R_a = getattr(t_affine, fn)(x, *extra, **CPU)
    _close(S_l, S_a, 1e-14)
    _close(R_l, R_a, 1e-14)
    S_j = getattr(j_affine, fn)(list(x), *extra)[0]
    assert float(tpro.aligned_rmse(S_l, torch.from_numpy(np.array(S_j)))) < 1e-8
    W, t = t_affine._get_observation_matrix(list(x), **CPU)
    jW, jt = j_affine._get_observation_matrix(list(x))
    _close(W, jW, 1e-14)
    _close(t, jt, 1e-14)
    with pytest.raises(ValueError):
        t_affine.orthographic_self_calibration([x[0], x[1][:-1]], **CPU)


def test_perspective_shim_matches_jax(scene):
    """The list input, the (X, R, t, K) return and the full result with
    ``eig_method`` equal JAX's shim (both through ``lowrank``, so that JAX
    compiles one depth loop)."""
    x = scene[0]
    got = t_persp.perspective_self_calibration([xi for xi in x], 1.0, tol=1e-2, method="dual",
                                               eig_method="lowrank", **CPU)
    want = j_persp.perspective_self_calibration([xi for xi in x], 1.0, tol=1e-2, method="dual",
                                                eig_method="lowrank")
    for g, w in zip(got, want):
        _close(g, w, 1e-8)
    full = t_persp.perspective_self_calibration_full(x, tol=1e-2, method="dual",
                                                     eig_method="lowrank", **CPU)
    jfull = j_persp.perspective_self_calibration_full(x, tol=1e-2, method="dual",
                                                      eig_method="lowrank")
    assert full.status == int(jfull.status) == 0
    _close(full.X, jfull.X, 1e-8)


def test_helpers_match_jax(scene):
    """The helpers only the compat layer reaches."""
    rng = np.random.default_rng(7)
    m = rng.standard_normal((6, 3, 3)) + 3 * np.eye(3)
    b = rng.standard_normal((6, 3))
    _close(tlin.solve3x3(torch.from_numpy(m), torch.from_numpy(b)),
           jlin.solve3x3(jnp.asarray(m), jnp.asarray(b)), 1e-12)
    sym = m + m.transpose(0, 2, 1)
    (w_t, v_t), (w_j, v_j) = (tlin.max_eigvec_sym(torch.from_numpy(sym)),
                              jlin.max_eigvec_sym(jnp.asarray(sym)))
    _close(w_t, w_j, 1e-12)
    _close(np.abs((_np(v_t) * np.asarray(v_j)).sum(-1)), np.ones(6), 1e-12)  # up to sign
    low = np.tril(m) + 2 * np.eye(3)
    rhs = rng.standard_normal((6, 3, 4))
    _close(tlin.solve_lower3(torch.from_numpy(low), torch.from_numpy(rhs)),
           jlin.solve_lower3(jnp.asarray(low), jnp.asarray(rhs)), 1e-12)
    _close(tlin.blockdiag_scatter(torch.from_numpy(m)),
           jlin.blockdiag_scatter(jnp.asarray(m)), 0)
    omega = rng.standard_normal((2, 4, 3))
    _close(trot.rodrigues_batched(torch.from_numpy(omega)),
           jrot.rodrigues_batched(jnp.asarray(omega)), 1e-12)
    _, X, _, R, t = scene
    for method in ("first_camera", "predict"):
        got = tpersp_core.correct_world_coordinates(*map(torch.from_numpy, (X, R, t)), method)
        want = jpersp_core.correct_world_coordinates(*map(jnp.asarray, (X, R, t)), method)
        for g, w in zip(got, want):
            _close(g, w, 1e-12)
    with pytest.raises(ValueError):
        tpersp_core.correct_world_coordinates(*map(torch.from_numpy, (X, R, t)), "median")
    gen = torch.Generator().manual_seed(0)
    noisy = add_noise(gen, torch.zeros(20000, 3, dtype=torch.float64), 0.5)
    assert noisy.dtype == torch.float64 and abs(float(noisy.std()) - 0.5) < 0.01


MST_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 3), (2, 4), (3, 4), (3, 5), (4, 6), (5, 6),
                      (1, 2), (2, 3), (5, 4)])
MST_WEIGHTS = np.array([2, 3, 5, 7, 2, 15, 1, 11, 8, 3, 3, 8], dtype=float)  # ties: 2, 3, 8


def _numpy_kruskal(edges, weights):
    """Kruskal in plain numpy over a stable weight sort: the rows kept."""
    order = np.argsort(weights, kind="stable")
    uf = t_mst.UnionFind(int(edges.max()) + 1)
    return [k for k in order if uf.union(int(edges[k, 0]), int(edges[k, 1]))]


def test_mst_matches_jax_with_ties():
    """The native route (built from the port's own ``mst.cpp``) keeps the
    same tied edges as JAX's shim and as a plain numpy Kruskal, on a small
    graph and on a 300-node graph whose weights are mostly tied."""
    assert mst_native.available(), mst_native.build_error()
    assert mst_native.library_path().parent.name == "native"
    got = t_mst.MinimumSpanningTree(MST_EDGES, MST_WEIGHTS).solve()
    want = j_mst.MinimumSpanningTree(MST_EDGES, MST_WEIGHTS).solve()
    np.testing.assert_array_equal(got, np.asarray(want))
    mst = t_mst.MinimumSpanningTree(MST_EDGES, MST_WEIGHTS)
    adj, dist = mst.to_adjacency_matrix(got)
    jadj, jdist = j_mst.MinimumSpanningTree(MST_EDGES, MST_WEIGHTS).to_adjacency_matrix(want)
    np.testing.assert_array_equal(adj, jadj)
    np.testing.assert_array_equal(dist, jdist)
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 300, size=(3000, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    weights = rng.integers(0, 5, size=len(edges)).astype(float)
    got = t_mst.MinimumSpanningTree(edges, weights).solve()
    np.testing.assert_array_equal(got, np.asarray(j_mst.MinimumSpanningTree(edges,
                                                                            weights).solve()))
    keep = _numpy_kruskal(edges, weights)
    np.testing.assert_array_equal(got[:, :2], edges[keep])
    with pytest.raises(ValueError):
        mst_native.kruskal(np.array([0]), np.array([5]), 3)


def _ba_start(scene):
    """x (P, F, 2) and a start (X, K, R, t) with X and t moved by 0.02."""
    x, X, K, R, t = scene
    rng = np.random.default_rng(3)
    return (x.transpose(1, 0, 2).copy(), X + 0.02 * rng.standard_normal(X.shape), K, R,
            t + 0.02 * rng.standard_normal(t.shape))


def test_bundle_adjuster_log_matches_jax_and_chunked_dispatch(scene, monkeypatch):
    """``BundleAdjuster``'s debug log equals JAX's record for record
    (1e-8); with the threshold lowered it dispatches to the chunked core,
    whose scalar log equals the dense one's errors (1e-8). The chunked
    core runs in chunks of 64, for one iteration: its fused build pads the
    cameras to a 4608-wide system whatever the scene, whose solves take
    2.8 s an iteration in float64 on one CPU thread."""
    start = _ba_start(scene)

    def run(mod, max_iter=2, **kw):
        ba = mod.BundleAdjuster(*start, axis=AXIS, **kw)
        out = ba.optimize(2.0, 0.0, max_iter=max_iter, is_debug=True)
        return ba, out

    dense, out = run(t_ba_shim, **CPU)
    jdense, jout = run(j_ba_shim)
    for g, w in zip(out, jout):
        _close(g, w, 1e-8)
    dlog, jlog_ = dense.get_log(), jdense.get_log()
    assert len(dlog) == len(jlog_) == 3
    for a, b in zip(dlog, jlog_):
        assert a.keys() == b.keys() == {"points", "basis", "pos", "reprojection_error"}
        for k in ("points", "basis", "pos"):
            _close(a[k], b[k], 1e-8)
        assert a["reprojection_error"] == pytest.approx(b["reprojection_error"], rel=1e-8)
    monkeypatch.setattr(t_ba_shim.BundleAdjuster, "CHUNKED_THRESHOLD_BYTES", 1)
    monkeypatch.setattr(t_ba_shim, "bundle_adjust_chunked",
                        functools.partial(tbc.bundle_adjust_chunked, chunk_size=64))
    chunked, _ = run(t_ba_shim, max_iter=1, **CPU)
    clog = chunked.get_log()
    assert len(clog) == 2 and set(clog[0]) == {"reprojection_error"}
    for a, b in zip(dlog, clog):
        assert b["reprojection_error"] == pytest.approx(a["reprojection_error"], rel=1e-8)
    assert "n_solver_retries_total" in chunked.result.log  # the chunked core's result


# ------------------------------------------------------------ API surface

COMPAT_MODULES = ["bundle_adjustment", "camera", "factorization", "affine_camera_calibration",
                  "perspective_camera_calibration", "utils", "visualization",
                  "minimum_spanning_tree"]


def _surface(path):
    """(public functions and classes defined, {class: public methods},
    public names imported) of a module, from its AST."""
    tree = ast.parse(path.read_text())
    defs, methods, imported = set(), {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            defs.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = {n.name for n in node.body
                                      if isinstance(n, ast.FunctionDef)
                                      and not n.name.startswith("_")}
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            imported |= {a.asname or a.name for a in node.names
                         if not (a.asname or a.name).startswith("_")}
    return defs, methods, imported


@pytest.mark.parametrize("name", COMPAT_MODULES)
def test_compat_module_surface_equals_jax(name):
    """Every compat module defines JAX's public functions and classes
    (with their public methods) and no others, and every public name JAX's
    module takes from the package is an attribute of the port's."""
    import importlib

    defs, methods, imported = _surface(JAX_ROOT / f"{name}.py")
    t_defs, t_methods, _ = _surface(PORT_ROOT / f"{name}.py")
    assert t_defs == defs
    assert t_methods == methods
    mod = importlib.import_module(f"mvrecon_tpu_torch.{name}")
    assert not [n for n in imported if not hasattr(mod, n)]


@pytest.mark.parametrize("package", ["ops", "geometry", "models", "viz"])
def test_package_reexports_cover_jax(package):
    """Every name JAX's package ``__init__`` re-exports is importable from
    the port's package."""
    import importlib

    _, _, names = _surface(JAX_ROOT / package / "__init__.py")
    mod = importlib.import_module(f"mvrecon_tpu_torch.{package}")
    assert names and not [n for n in names if not hasattr(mod, n)]
    from mvrecon_tpu_torch.models import ba_covariance  # noqa: F401
    from mvrecon_tpu_torch.ops import triangulate, umeyama  # noqa: F401


# ------------------------------------------------------------ plotting

def test_plotters_render_tensors(monkeypatch):
    """The reference's plotter classes and the ``show_*`` helpers draw
    tensors headless (``plt.show`` patched out)."""
    import matplotlib.pyplot as plt

    from mvrecon_tpu_torch import visualization
    from mvrecon_tpu_torch.viz import plotting

    monkeypatch.setattr(plt, "show", lambda: None)
    p = visualization.ThreeDimensionalPlotter(title="test")
    p.set_lim()
    p.plot_points(torch.randn(50, 3, generator=torch.Generator().manual_seed(0)))
    p.plot_basis(torch.eye(3), torch.zeros(3), label="cam0")
    p.fig.canvas.draw()
    p.close()
    p = visualization.TwoDimensionalMatrixPlotter(2, 3)
    for i in range(6):
        p.select(i)
        p.set_property(f"Camera {i}")
        p.plot_points(torch.randn(20, 2), label="x")
    p.plt.gcf().canvas.draw()
    p.close()
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene as t_scene

    sc = t_scene(torch.Generator().manual_seed(0), n_images=7)
    visualization.show_3d_scene_data(sc.X, sc.R, sc.t)
    visualization.show_2d_projection_data(list(sc.x), list(sc.x), n_col=3)
    log = tlog.device_log_to_records({k: torch.from_numpy(v) for k, v in _random_log().items()},
                                     1)
    fig, ax = plotting.new_axes3d()
    plotting.draw_scene(ax, X=log[0]["points"], R=log[0]["basis"], t=log[0]["pos"])
    plt.close("all")


def test_port_imports_without_matplotlib():
    """With matplotlib absent (as on the machine with the card), every
    module of the port imports; only drawing needs it."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['matplotlib'] = None\n"
        "import mvrecon_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mvrecon_tpu_torch.__path__, "
        "'mvrecon_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'mvrecon_tpu_torch.visualization' in names, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PORT_ROOT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, cwd=str(PORT_ROOT.parent))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 40
