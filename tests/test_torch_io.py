"""The port's ``runtime/io.py`` and its ``bal`` subcommand, held against the
JAX package on the CPU:

- every writer (npz, BAL dense and observation-list, COLMAP text and
  binary for each family the writer knows, PLY) writes the same bytes as
  JAX's, and every loader returns what JAX's returns, on files written in
  ``tmp_path``; COLMAP's eleven camera models load from text and binary
  ``cameras`` files alike;
- ``python -m mvrecon_tpu_torch bal`` on one COLMAP directory gives JAX's
  ``cli.main(["bal", ...])`` record to 1e-8 in float64 for fisheye, FOV and
  thin prism, dense and with ``--chunk-size``, with ``--covariance`` and
  ``--optimize-distortion 1``, and the same undistorted pinhole model; on a
  BAL file (radial) too;
- ``--sparse`` and ``--shard-points`` raise ``NotImplementedError`` naming
  the ROADMAP items that port them.
"""

import json
import pathlib
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu import cli as jcli
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models import bundle_adjustment as jba
from mvrecon_tpu.runtime import io as jio
from mvrecon_tpu_torch.__main__ import main as tmain
from mvrecon_tpu_torch.runtime import io as tio

NF = 6
TRUTH = {
    "radial": np.array([-0.3, 0.05]),
    "opencv": np.array([-0.28, 0.035, 0.018, -0.012]),
    "fisheye": np.array([-0.08, 0.02, 0.008, -0.004]),
    "full_opencv": np.array([-0.30, 0.05, -0.01, -0.12, 0.02, 0.005, 0.015, -0.01]),
    "fov": np.array([0.9]),
    "thin_prism": np.array([-0.06, 0.015, -0.004, 0.002, 0.012, -0.009, 0.006, -0.005]),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(model, seed=0, noise=0.001):
    """(x (F, P, 2) rendered through a per-camera ``model`` around
    ``TRUTH`` with JAX's terms, vis (P, F) with 10 % unseen, X0, R, t0, f,
    principal point, the distortion): X and t perturbed by 0.003."""
    sc = make_synthetic_scene(jax.random.key(seed), n_images=NF, n_slices=3, n_angles=20,
                              dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    dist = TRUTH[model] * (1.0 + 0.1 * rng.standard_normal((NF, TRUTH[model].size)))
    pp = 0.01 * rng.standard_normal((NF, 2))
    st = jba.BAState(X=sc.X, f=sc.K[:, 0, 0], u=jnp.asarray(pp), t=sc.t, R=sc.R)
    _, p, q, r = jba.calc_pqr(st.X, jba.build_K(st.f, st.u, 1.0), st.R, st.t)
    x = np.asarray(jnp.stack(jba._distorted_residual(st, p, q, r, jnp.zeros(p.shape + (2,)), 1.0,
                                                     jnp.asarray(dist), model), -1))
    x = (x + noise * rng.standard_normal(x.shape)).transpose(1, 0, 2)
    vis = (rng.uniform(size=x.shape[1::-1]) > 0.1).astype(np.float64)
    vis[:, :2] = 1.0
    X0 = np.asarray(sc.X) + 0.003 * rng.standard_normal(sc.X.shape)
    t0 = np.asarray(sc.t) + 0.003 * rng.standard_normal(sc.t.shape)
    return x, vis, X0, np.asarray(sc.R), t0, np.asarray(sc.K[:, 0, 0]), pp, dist


def _same_files(a: pathlib.Path, b: pathlib.Path):
    names = sorted(p.name for p in a.iterdir()) if a.is_dir() else [None]
    assert (sorted(p.name for p in b.iterdir()) if b.is_dir() else [None]) == names
    for n in names:
        fa, fb = (a, b) if n is None else (a / n, b / n)
        assert fa.read_bytes() == fb.read_bytes(), n


def _same_dict(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ----------------------------------------------------------- the writers

@pytest.mark.parametrize("model", [None] + list(TRUTH))
@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_colmap_writer_and_loader_match_jax(tmp_path, model, binary):
    x, vis, X0, R, t0, f, pp, dist = _scene(model or "radial")
    kw = dict(principal_point=pp, binary=binary,
              distortion=None if model is None else dist,
              distortion_model=model if model in ("fisheye", "thin_prism") else None)
    tio.save_colmap(str(tmp_path / "t"), x, vis, X0, R, t0, f, **kw)
    jio.save_colmap(str(tmp_path / "j"), x, vis, X0, R, t0, f, **kw)
    _same_files(tmp_path / "t", tmp_path / "j")
    got, want = tio.load_colmap(str(tmp_path / "t")), jio.load_colmap(str(tmp_path / "j"))
    _same_dict(got, want)
    assert str(got["distortion_model"]) == (model or "radial")


# COLMAP camera models the writer does not emit, with their parameters
REDUCED = {
    "SIMPLE_PINHOLE": [1.1, 0.01, -0.02],
    "PINHOLE": [1.1, 1.1, 0.01, -0.02],
    "SIMPLE_RADIAL": [1.1, 0.01, -0.02, -0.2],
    "RADIAL": [1.1, 0.01, -0.02, -0.2, 0.04],
    "SIMPLE_RADIAL_FISHEYE": [1.1, 0.01, -0.02, -0.05],
    "RADIAL_FISHEYE": [1.1, 0.01, -0.02, -0.05, 0.01],
}


@pytest.mark.parametrize("name", list(REDUCED))
@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_colmap_reduced_camera_models_load_as_in_jax(tmp_path, name, binary):
    """The camera models the writer does not emit, written into the
    cameras file by hand, text and binary: the port's loader returns JAX's
    arrays."""
    x, vis, X0, R, t0, f, pp, _ = _scene("radial")
    tio.save_colmap(str(tmp_path), x, vis, X0, R, t0, f, principal_point=pp, binary=binary)
    params = REDUCED[name]
    if binary:
        with open(tmp_path / "cameras.bin", "wb") as fh:
            fh.write(struct.pack("<Q", NF))
            for i in range(NF):
                fh.write(struct.pack("<IiQQ", i + 1, tio._COLMAP_MODEL_IDS[name], 4, 4))
                fh.write(struct.pack(f"<{len(params)}d", *params))
    else:
        (tmp_path / "cameras.txt").write_text("".join(
            f"{i + 1} {name} 4 4 " + " ".join(repr(v) for v in params) + "\n"
            for i in range(NF)))
    _same_dict(tio.load_colmap(str(tmp_path)), jio.load_colmap(str(tmp_path)))


def test_bal_npz_and_ply_match_jax(tmp_path):
    """BAL (dense and observation-list), npz and PLY: the same bytes, and
    the loaders return JAX's arrays."""
    x, vis, X0, R, t0, f, _, dist = _scene("radial")
    for mod, tag in ((tio, "t"), (jio, "j")):
        mod.save_bal(str(tmp_path / f"{tag}.bal"), x, vis, X0, R, t0, f, distortion=dist)
        pi, ci = np.nonzero(vis > 0)
        mod.save_bal_sparse(str(tmp_path / f"{tag}_sparse.bal"), pi, ci, x[ci, pi], x.shape[1],
                            X0, R, t0, f, distortion=dist)
        mod.save_observations(str(tmp_path / f"{tag}.npz"), x, visibility=vis, f=f, f0=1.0,
                              X=X0)
        mod.save_ply(str(tmp_path / f"{tag}.ply"), X0, cameras=t0,
                     quality=np.linspace(0.0, 1.0, X0.shape[0]))
    for name in ("{}.bal", "{}_sparse.bal", "{}.ply"):
        _same_files(tmp_path / name.format("t"), tmp_path / name.format("j"))
    _same_dict(tio.load_bal(str(tmp_path / "t.bal")), jio.load_bal(str(tmp_path / "j.bal")))
    _same_dict(tio.load_bal_sparse(str(tmp_path / "t.bal")),
               jio.load_bal_sparse(str(tmp_path / "j.bal")))
    _same_dict(tio.load_observations(str(tmp_path / "t.npz")),
               jio.load_observations(str(tmp_path / "j.npz")))
    with pytest.raises(ValueError, match="k1, k2"):
        tio.save_bal(str(tmp_path / "bad.bal"), x, vis, X0, R, t0, f,
                     distortion=np.zeros((NF, 4)))


# ------------------------------------------------------------------- bal

def _records(capsys, argv):
    """(the port's record, JAX's record) of ``bal`` with ``argv``."""
    assert tmain(["bal"] + argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(["bal"] + argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got, want


def _check_records(got, want):
    assert got["device"] == "cpu" and got["dtype"] == "float64"
    skip = {"total_wall_s", "device", "dtype"}
    assert set(want) - skip <= set(got)
    for k, w in want.items():
        if k in skip:
            continue
        if isinstance(w, float):
            np.testing.assert_allclose(got[k], w, rtol=1e-8, atol=1e-14, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("model", ["fisheye", "fov", "thin_prism"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["dense", "chunked"])
def test_bal_matches_jax_on_a_colmap_model(tmp_path, capsys, model, chunk):
    x, vis, X0, R, t0, f, pp, dist = _scene(model)
    mdir = tmp_path / "model"
    tio.save_colmap(str(mdir), x, vis, X0, R, t0, f, principal_point=pp, distortion=dist,
                    distortion_model=model if model != "fov" else None)
    argv = [str(mdir), "--float64", "--max-iter", "5", "--optimize-distortion", "1",
            "--covariance"]
    if chunk:
        argv += ["--chunk-size", str(chunk)]
    got, want = _records(capsys, argv + ["--output-colmap-pinhole", str(tmp_path / "pin_t"),
                                         "--output", str(tmp_path / "t.npz")])
    _check_records(got, want)
    assert got["camera_model"] == model and got["format"] == "colmap"
    assert ("omega_mean" in got) == (model == "fov")
    jcli.main(["bal"] + argv + ["--output-colmap-pinhole", str(tmp_path / "pin_j")])
    capsys.readouterr()
    t, j = tio.load_colmap(str(tmp_path / "pin_t")), jio.load_colmap(str(tmp_path / "pin_j"))
    assert not t["distortion"].any() and t["distortion"].shape == (NF, 2)
    for k in ("x", "X", "R", "t", "K"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-8, err_msg=k)
    saved = tio.load_observations(str(tmp_path / "t.npz"))
    assert saved["point_cov"].shape == (X0.shape[0], 3, 3)
    assert saved["distortion"].shape == dist.shape


def test_bal_matches_jax_on_a_bal_file(tmp_path, capsys):
    """A BAL file (radial): the dense core with the PLY, BAL and COLMAP
    writers."""
    x, vis, X0, R, t0, f, _, dist = _scene("radial")
    path = tmp_path / "problem.bal"
    tio.save_bal(str(path), x, vis, X0, R, t0, f, distortion=dist)
    argv = [str(path), "--float64", "--max-iter", "5", "--optimize-distortion", "1",
            "--huber", "0.003"]
    outs = {}
    for tag in ("t", "j"):
        outs[tag] = ["--output-ply", str(tmp_path / f"{tag}.ply"), "--output-bal",
                     str(tmp_path / f"{tag}.bal"), "--output-colmap", str(tmp_path / f"{tag}_c")]
    assert tmain(["bal"] + argv + outs["t"] + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(["bal"] + argv + outs["j"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("output_ply", "output_bal", "output_colmap"):
        got[k] = want[k]
    _check_records(got, want)
    t, j = tio.load_bal(str(tmp_path / "t.bal")), jio.load_bal(str(tmp_path / "j.bal"))
    for k in ("x", "X", "R", "t", "distortion"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-8, err_msg=k)


def test_bal_unported_options_raise(tmp_path, capsys):
    x, vis, X0, R, t0, f, _, dist = _scene("radial")
    path = str(tmp_path / "problem.bal")
    tio.save_bal(path, x, vis, X0, R, t0, f, distortion=dist)
    # --sparse is ported (the observation-list core): it runs and prints its record
    assert tmain(["bal", path, "--sparse", "--max-iter", "2", "--device", "cpu",
                  "--float64"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["sparse"] is True and rec["observations"] == int(vis.sum())
    assert rec["ba_iterations"] <= 2 and np.isfinite(rec["reprojection_error"])
    # the sharded cores are not: --shard-points raises, with --sparse too
    for extra in ([], ["--sparse"]):
        with pytest.raises(NotImplementedError, match="item 10"):
            tmain(["bal", path, "--shard-points", "2", "--device", "cpu"] + extra)
