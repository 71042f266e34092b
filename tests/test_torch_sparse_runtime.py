"""The port's observation-list triangulation, npz checkpoints, resumable
drivers and ``bal --sparse``, held against the JAX package on the CPU on
the same numpy inputs (float64):

- ``triangulate_sparse`` against JAX's to 1e-8, with weights and an unseen
  point (at the origin on both sides); points seen once are ill-posed and
  left out of the comparison;
- the npz checkpoint round trip, its structure and leaf-count checks, the
  atomic write, and the JAX-only orbax backend refused;
- ``run_with_retries``;
- ``resumable_bundle_adjust`` (chunked core) and
  ``resumable_bundle_adjust_sparse``: segments of 2 against one continuous
  run (the same X, E and damping to 1e-10), a run killed after one segment
  and re-invoked, and against JAX's resumable drivers (E rtol 1e-8);
- ``bal --sparse``, with and without ``--triangulate-init``, against
  ``mvrecon_tpu.cli.main`` on one BAL file: the records to 1e-6 and the
  written PLY and BAL read back.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvrecon_tpu import cli as jcli
from mvrecon_tpu.config import LMConfig as JLMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment_sparse as jbs
from mvrecon_tpu.ops.triangulation import triangulate_sparse as j_tri
from mvrecon_tpu.runtime import elastic as jel
from mvrecon_tpu_torch.__main__ import main as tmain
from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.interop import sparse_obs_from_numpy
from mvrecon_tpu_torch.ops.triangulation import triangulate_sparse as t_tri
from mvrecon_tpu_torch.runtime import checkpoint as tck
from mvrecon_tpu_torch.runtime import elastic as tel
from mvrecon_tpu_torch.runtime import io as tio

AXIS = "x-up_z-forward"
CFG = dict(scale_factor=4.0, delta_tol=1e-10, max_iter=6, accept_divisor=1.0,
           init_damping=3e-3, damping="nielsen")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n_images=8, n_slices=10, vis_frac=0.6, seed=0, noise=0.02):
    key = jax.random.key(seed)
    sc = make_synthetic_scene(key, n_images=n_images, n_slices=n_slices, n_angles=20,
                              dtype=jnp.float64)
    k1, k2 = jax.random.split(key)
    X0 = np.asarray(sc.X + noise * jax.random.normal(k1, sc.X.shape, dtype=jnp.float64))
    t0 = np.asarray(sc.t + noise * jax.random.normal(k2, sc.t.shape, dtype=jnp.float64))
    x = np.array(sc.x.transpose(1, 0, 2))  # (P, F, 2)
    vis = (np.random.default_rng(seed).random(x.shape[:2]) < vis_frac).astype(np.float64)
    return x, vis, X0, np.asarray(sc.K), np.asarray(sc.R), t0


SCENE = _scene()


def test_triangulate_sparse_matches_jax():
    x, vis, _, K, R, t = SCENE
    vis = vis.copy()
    vis[3] = 0.0  # an unseen point
    pi, ci = np.nonzero(vis > 0)
    xy = x[pi, ci]
    w = 0.5 + np.random.default_rng(1).random(len(pi))
    n = x.shape[0]
    for weights in (None, w):
        want = np.asarray(j_tri(jnp.asarray(pi, jnp.int32), jnp.asarray(ci, jnp.int32),
                                jnp.asarray(xy), n, jnp.asarray(K), jnp.asarray(R),
                                jnp.asarray(t), weights=None if weights is None
                                else jnp.asarray(weights)))
        got = t_tri(pi, ci, xy, n, K, R, t, weights=weights, device="cpu").numpy()
        posed = np.bincount(pi, minlength=n) >= 2
        np.testing.assert_allclose(got[posed], want[posed], rtol=0, atol=1e-8)
        np.testing.assert_array_equal(got[3], np.zeros(3))
        np.testing.assert_array_equal(want[3], np.zeros(3))


def test_checkpoint_round_trip_and_checks(tmp_path):
    path = str(tmp_path / "state.npz")
    tree = {"X": torch.arange(6.0).reshape(2, 3), "c": np.asarray(3e-3),
            "cams": (np.eye(3), [np.ones(2), None]), "nu": 2.0}
    tck.save_checkpoint(path, tree, step=7)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state.npz"]
    like = {"X": 0, "c": 0, "cams": (0, [0, None]), "nu": 0}
    got, step = tck.load_checkpoint(path, like)
    assert step == 7 and set(got) == set(like)
    np.testing.assert_array_equal(got["X"], np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(got["cams"][0], np.eye(3))
    assert got["cams"][1][1] is None and float(got["nu"]) == 2.0
    with pytest.raises(ValueError, match="structure"):
        tck.load_checkpoint(path, {"X": 0, "c": 0, "cams": [0, [0, None]], "nu": 0})
    with pytest.raises(ValueError, match="leaves"):
        tck.load_checkpoint(path, {"X": 0, "c": 0})
    save, load, exists = tck.checkpoint_backend("npz")
    assert exists(path) and load is tck.load_checkpoint and save is tck.save_checkpoint
    with pytest.raises(NotImplementedError, match="JAX-only"):
        tck.checkpoint_backend("orbax")
    with pytest.raises(ValueError, match="unknown"):
        tck.checkpoint_backend("hdf5")


def test_run_with_retries():
    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert tel.run_with_retries(flaky, max_attempts=3, backoff_s=0.0,
                                on_retry=lambda a, e: seen.append(a)) == "ok"
    assert len(calls) == 3 and seen == [0, 1]
    with pytest.raises(RuntimeError, match="always"):
        tel.run_with_retries(lambda: (_ for _ in ()).throw(RuntimeError("always")),
                             max_attempts=2, backoff_s=0.0)
    with pytest.raises(KeyError):
        tel.run_with_retries(lambda: {}["x"], backoff_s=0.0)


def _state_close(a, b, atol=1e-10):
    for k in ("X", "K", "R", "t"):
        np.testing.assert_allclose(getattr(a, k).numpy(), getattr(b, k).numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def test_resumable_chunked_matches_continuous_and_jax(tmp_path):
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked

    x, vis, X0, K, R, t0 = SCENE
    cfg = LMConfig(**CFG)
    kw = dict(f0=1.0, visibility=vis, axis=AXIS, chunk_size=64)
    cont = bundle_adjust_chunked(x, X0, K, R, t0, config=cfg, device="cpu", **kw)
    seg, ran = tel.resumable_bundle_adjust(x, X0, K, R, t0, str(tmp_path / "c.npz"),
                                           total_iters=6, segment_iters=2, config=cfg,
                                           device="cpu", **kw)
    assert ran == cont.n_iter == 6
    assert float(seg.error) == pytest.approx(float(cont.error), rel=1e-10)
    _state_close(seg, cont)
    want, _ = jel.resumable_bundle_adjust(x, X0, K, R, t0, str(tmp_path / "j.npz"),
                                          total_iters=6, segment_iters=2,
                                          config=JLMConfig(**CFG), **kw)
    assert float(seg.error) == pytest.approx(float(want.error), rel=1e-8)
    np.testing.assert_allclose(seg.X.numpy(), np.asarray(want.X), rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="distortion"):
        tel.resumable_bundle_adjust(x, X0, K, R, t0, str(tmp_path / "d.npz"), total_iters=2,
                                    config=LMConfig(distortion_rounds=1), device="cpu", **kw)


def test_resumable_sparse_matches_continuous_kill_and_jax(tmp_path):
    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import bundle_adjust_sparse

    x, vis, X0, K, R, t0 = SCENE
    jo = jbs.dense_to_sparse_obs(x, vis)
    to = sparse_obs_from_numpy(*(np.asarray(a) for a in jo), device="cpu", dtype=torch.float64)
    cfg = LMConfig(**CFG)
    kw = dict(f0=1.0, axis=AXIS, cg_tol=1e-12, cg_max_iter=500)
    cont = bundle_adjust_sparse(to, X0, K, R, t0, config=cfg, device="cpu", **kw)
    ck = str(tmp_path / "s.npz")
    done = []
    seg, ran = tel.resumable_bundle_adjust_sparse(
        to, X0, K, R, t0, ck, total_iters=6, segment_iters=2, config=cfg, device="cpu",
        on_segment=lambda d, r: done.append(d), **kw)
    assert ran == cont.n_iter == 6 and done == [2, 4, 6]
    assert float(seg.error) == pytest.approx(float(cont.error), rel=1e-10)
    _state_close(seg, cont)
    assert float(seg.log["c"]) == pytest.approx(float(cont.log["c"]), rel=1e-10)
    # killed after one segment, then re-invoked: it resumes at iteration 2
    ck2 = str(tmp_path / "killed.npz")
    _, first = tel.resumable_bundle_adjust_sparse(to, X0, K, R, t0, ck2, total_iters=2,
                                                  segment_iters=2, config=cfg, device="cpu",
                                                  **kw)
    resumed, rest = tel.resumable_bundle_adjust_sparse(to, X0, K, R, t0, ck2, total_iters=6,
                                                       segment_iters=2, config=cfg,
                                                       device="cpu", **kw)
    assert (first, rest) == (2, 4)
    assert float(resumed.error) == pytest.approx(float(cont.error), rel=1e-10)
    _state_close(resumed, cont)
    want, n = jel.resumable_bundle_adjust_sparse(jo, X0, K, R, t0, str(tmp_path / "j.npz"),
                                                 total_iters=6, segment_iters=2,
                                                 config=JLMConfig(**CFG), **kw)
    assert n == ran
    assert float(seg.error) == pytest.approx(float(want.error), rel=1e-8)
    np.testing.assert_allclose(seg.X.numpy(), np.asarray(want.X), rtol=0, atol=1e-7)


def test_resumable_sparse_stops_on_convergence(tmp_path):
    x, vis, X0, K, R, t0 = SCENE
    to = sparse_obs_from_numpy(*(np.asarray(a) for a in jbs.dense_to_sparse_obs(x, vis)),
                               device="cpu", dtype=torch.float64)
    cfg = LMConfig(**{**CFG, "delta_tol": 1e-6})
    res, ran = tel.resumable_bundle_adjust_sparse(to, X0, K, R, t0, str(tmp_path / "s.npz"),
                                                  total_iters=40, segment_iters=1,
                                                  config=cfg, device="cpu", cg_tol=1e-10)
    assert res.log["converged"] and ran < 40


def _bal_file(tmp_path):
    x, vis, X0, K, R, t0 = SCENE
    path = str(tmp_path / "problem.bal")
    nf = K.shape[0]
    dist = np.tile([[-0.02, 0.003]], (nf, 1))
    tio.save_bal(path, x.transpose(1, 0, 2), vis, X0, R, t0, K[:, 0, 0], distortion=dist)
    return path


@pytest.mark.parametrize("extra", [[], ["--triangulate-init"]], ids=["file", "triangulated"])
def test_bal_sparse_matches_jax(tmp_path, capsys, extra):
    path = _bal_file(tmp_path)
    argv = ["bal", path, "--sparse", "--max-iter", "5", "--huber", "0.05",
            "--optimize-distortion", "1", "--cg-max-iter", "60"] + extra
    outs = {tag: ["--output-ply", str(tmp_path / f"{tag}.ply"), "--output-bal",
                  str(tmp_path / f"{tag}.bal")] for tag in ("t", "j")}
    assert tmain(argv + outs["t"] + ["--device", "cpu", "--float64"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(argv + outs["j"] + ["--float64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["dtype"] == "float64"
    assert set(want) - {"output_ply", "output_bal"} <= set(got)
    for k, w in want.items():
        if k in ("output_ply", "output_bal"):
            continue
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, err_msg=k)
        else:
            assert got[k] == w, k
    assert got.get("triangulate_init", False) == bool(extra)
    t, j = tio.load_bal_sparse(str(tmp_path / "t.bal")), tio.load_bal_sparse(
        str(tmp_path / "j.bal"))
    for k in ("point_idx", "cam_idx", "xy"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in ("X", "R", "t", "distortion"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6, err_msg=k)
    ply = (tmp_path / "t.ply").read_bytes()
    assert ply.startswith(b"ply") and b"element vertex" in ply


def test_bal_sparse_rejects_a_colmap_directory(tmp_path):
    (tmp_path / "model").mkdir()
    with pytest.raises(SystemExit, match="BAL files"):
        tmain(["bal", str(tmp_path / "model"), "--sparse", "--device", "cpu"])
