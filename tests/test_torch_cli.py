"""The port's command line (``mvrecon_tpu_torch/cli.py``) on the CPU:

- ``reconstruct`` against the JAX package's ``cli.main`` on one npz file
  with a visibility mask over corrupted observations and ``X_gt``,
  without and with ``--covariance``: the same record keys (the port's
  extras named), the same status and iterations, E, the aligned RMSE, sigma
  and the point sigmas to 1e-8, the output npz arrays to 1e-8 in one world
  frame, the same PLY header and vertex count;
- ``reconstruct --pipeline affine`` with ``--log-json`` appending;
- ``bench-ba``, dense and ``--chunked``, under JAX's record keys;
- ``--profile`` writing a trace that holds the pipeline's spans, and
  ``--viz`` drawing headless;
- ``bal --sparse --profile`` (and its ``--shard-points 1`` form) timing
  the sparse core's spans into ``span_ms`` and the trace;
- every flag of JAX's subcommands but the XLA switches parses
  in the port's same-named subcommand.
"""

import json

import matplotlib

matplotlib.use("Agg")

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mvrecon_tpu import cli as jcli
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu_torch import cli as tcli
from mvrecon_tpu_torch.ops.procrustes import umeyama
from mvrecon_tpu_torch.runtime import io as tio
from mvrecon_tpu_torch.runtime.profiling import TRACE_FILE

# keys the port's records add to JAX's (``eig_method``: the depth loop's
# eigensolve, which the port picks from the card's free memory)
PORT_EXTRAS = {"device", "dtype", "wall_s", "stage_walls_s", "eig_method"}
# JAX's flags that the port does not take: XLA switches (``--device`` is the
# port's counterpart)
UNPORTED_FLAGS = {"--platform", "--num-cpu-devices"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small problems run faster on one intra-op thread, and the
    test workers then do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    """An npz of the reference scene (6 views x 200 points) with three
    observations moved by 0.08-0.12 and masked out in ``visibility``, and
    the true points as ``X_gt``."""
    sc = make_synthetic_scene(jax.random.key(9), n_images=6, dtype=jnp.float64)
    x = np.array(sc.x)
    vis = np.ones((x.shape[1], 6))
    for p, f, dx in ((3, 2, 0.10), (11, 4, -0.12), (40, 0, 0.08)):
        vis[p, f] = 0.0
        x[f, p] += dx
    path = str(tmp_path_factory.mktemp("tracks") / "tracks.npz")
    tio.save_observations(path, x, visibility=vis, X_gt=np.array(sc.X))
    return path


def _in_jax_frame(rec: dict, X_jax) -> dict:
    """The port's output arrays in the JAX run's world frame. The two
    calibrations' eigensolvers pick eigenvector signs independently
    (``tests/test_torch_perspective.py``), so the frames may differ by a
    rotation of pi about an axis; the similarity that aligns the port's X to
    JAX's takes points and positions, the rotations, and the covariance
    blocks (point blocks, the camera blocks' position and rotation rows;
    f and the principal point are frame-free) over."""
    sim = umeyama(torch.from_numpy(rec["X"]), torch.from_numpy(X_jax))
    q, s, b = (a.numpy() for a in (sim.R, sim.scale, sim.t))
    assert np.allclose(np.abs(q), np.eye(3), atol=1e-9) and abs(s - 1.0) < 1e-9
    out = dict(rec, X=rec["X"] @ (s * q).T + b, t=rec["t"] @ (s * q).T + b,
               R=np.einsum("ij,fjk->fik", q, rec["R"]))
    if "point_cov" in rec:
        cam = np.zeros((9, 9))
        cam[:3, :3], cam[3:6, 3:6], cam[6:, 6:] = np.eye(3), s * q, q
        m = s * q
        out["point_cov"] = m @ rec["point_cov"] @ m.T
        out["camera_cov"] = cam @ rec["camera_cov"] @ cam.T
    return out


def _ply_header(path):
    with open(path, "rb") as fh:
        lines = []
        while not lines or lines[-1] != b"end_header":
            lines.append(fh.readline().rstrip(b"\n"))
    return lines


@pytest.mark.parametrize("covariance", [False, True], ids=["plain", "covariance"])
def test_reconstruct_matches_jax(tracks, tmp_path, capsys, covariance):
    argv = ["reconstruct", tracks, "--max-iter", "15", "--float64", "--tol", "3e-2"]
    argv += ["--covariance"] if covariance else []
    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        outs[name] = (str(tmp_path / f"{name}.npz"), str(tmp_path / f"{name}.ply"))
        outs[name] += (_run(main, argv + extra + ["--output", outs[name][0],
                                                  "--output-ply", outs[name][1]], capsys),)
    want, got = outs["jax"][2], outs["port"][2]
    assert set(got) - set(want) == PORT_EXTRAS and set(want) <= set(got)
    assert got["device"] == "cpu" and got["dtype"] == "float64" and got["eig_method"] == "eigh"
    for k in ("command", "status", "ba_iterations", "n_points", "n_views", "n_visible",
              "output", "output_ply"):
        if k.startswith("output"):
            assert got[k] == outs["port"][("output", "output_ply").index(k)]
        else:
            assert got[k] == want[k], k
    assert got["status"] == 0 and got["n_visible"] == 1197
    floats = ["reprojection_error", "aligned_rmse_gt"]
    if covariance:
        floats += ["sigma", "point_sigma_median", "point_sigma_max"]
    for k in floats:
        assert got[k] == pytest.approx(want[k], rel=1e-8), k
    assert got["reprojection_error"] < 0.2  # at the floor: the corrupted entries are masked
    j_npz, t_npz = tio.load_observations(outs["jax"][0]), tio.load_observations(outs["port"][0])
    assert set(j_npz) == set(t_npz)
    assert ({"point_cov", "camera_cov", "sigma2"} <= set(t_npz)) == covariance
    for k, v in _in_jax_frame(t_npz, j_npz["X"]).items():
        w = j_npz[k]
        np.testing.assert_allclose(v, w, rtol=1e-8, atol=1e-8 * np.abs(w).max(), err_msg=k)
    assert _ply_header(outs["port"][1]) == _ply_header(outs["jax"][1])
    header = _ply_header(outs["port"][1])
    assert (b"property float quality" in header) == covariance
    assert b"element vertex 206" in header  # 200 points and 6 camera centres


def test_reconstruct_picks_the_eigensolve_from_free_memory(monkeypatch):
    """``reconstruct``'s depth eigensolve: the dense one, as JAX's command
    runs it, unless the dual method's four (F, P, P) arrays exceed the
    card's free memory; on the CPU always the dense one."""
    free = 80e9
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (free, 80e9))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    pick = tcli._reconstruct_eig_method
    assert pick("dual", 100, 10_000, cuda, torch.float32) == "lowrank"  # 160 GB
    assert pick("dual", 100, 2_000, cuda, torch.float32) == "eigh"  # 6.4 GB
    assert pick("dual", 100, 6_000, cuda, torch.float32) == "eigh"  # 57.6 GB
    assert pick("dual", 100, 6_000, cuda, torch.float64) == "lowrank"  # 115.2 GB
    assert pick("primary", 100, 10_000, cuda, torch.float32) == "eigh"  # (P, F, F) Grams
    assert pick("dual", 100, 10_000, cpu, torch.float32) == "eigh"
    free = 1e9
    assert pick("dual", 100, 2_000, cuda, torch.float32) == "lowrank"


def test_reconstruct_affine_appends_log_json(tracks, tmp_path, capsys):
    """The affine branch reaches the floor on the masked tracks; each run
    appends its printed record to the ``--log-json`` file."""
    log = tmp_path / "runs.jsonl"
    recs = [_run(tcli.main, ["reconstruct", tracks, "--pipeline", "affine", "--model", model,
                             "--max-iter", "30", "--float64", "--device", "cpu",
                             "--log-json", str(log)], capsys)
            for model in ("paraperspective", "symmetric")]
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert lines == recs
    for rec in recs:
        assert rec["status"] == 0 and rec["n_views"] == 6 and rec["n_points"] == 200
        assert np.isfinite(rec["reprojection_error"]) and rec["aligned_rmse_gt"] < 0.05
        assert set(rec["stage_walls_s"]) == {"affine_self_calibration", "bundle_adjustment"}


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
def test_bench_ba_runs_on_cpu(capsys, chunked):
    """One iteration: the chunked core's fused build spans 512 padded
    cameras (a 4608-wide system) whatever the scene, so each of its
    retries costs a second on the CPU."""
    argv = ["bench-ba", "--points", "200", "--views", "8", "--iters", "1", "--device", "cpu"]
    argv += ["--chunked", "--chunk-size", "64"] if chunked else []
    rec = _run(tcli.main, argv, capsys)
    assert {"command", "points", "views", "iters", "wall_s", "reprojection_error",
            "total_wall_s"} <= set(rec)
    assert (rec["points"], rec["views"], rec["iters"]) == (200, 8, 1)
    assert rec["chunked"] == chunked and rec["dtype"] == "float32"
    assert rec["ba_iterations"] == 1 and rec["wall_s"] > 0
    assert np.isfinite(rec["reprojection_error"])
    assert rec["reprojection_error"] < 0.5 * rec["start_error"]


def test_profile_writes_a_trace_and_viz_draws(tmp_path, capsys, monkeypatch):
    """``--profile DIR`` writes a Chrome trace holding the pipeline's
    stage spans and names DIR in the record; ``--viz`` draws the scene and
    the reprojections (``plt.show`` patched out)."""
    import matplotlib.pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(1))
    prof = tmp_path / "prof"
    rec = _run(tcli.main, ["euclidean", "--n-images", "6", "--max-iter", "3", "--float64",
                           "--device", "cpu", "--profile", str(prof), "--viz"], capsys)
    assert rec["profile_dir"] == str(prof) and rec["status"] == 0
    names = {e.get("name") for e in json.loads((prof / TRACE_FILE).read_text())["traceEvents"]}
    assert {"perspective_self_calibration", "bundle_adjustment"} <= names
    assert len(shown) == 2
    plt.close("all")


@pytest.mark.parametrize("shard", [False, True], ids=["one", "shard1"])
def test_bal_sparse_profile_times_the_core_spans(tmp_path, capsys, shard):
    """Under ``--profile DIR`` the sparse core gets a timer: the record's
    ``span_ms`` holds its spans' totals, and the trace in DIR holds them
    as ranges beside the operators."""
    sc = make_synthetic_scene(jax.random.key(4), n_images=6, dtype=jnp.float64)
    rng = np.random.default_rng(4)
    x = np.array(sc.x)
    vis = (rng.uniform(size=x.shape[1::-1]) > 0.2).astype(np.float64)
    vis[:, :2] = 1.0
    X0 = np.asarray(sc.X) + 0.01 * rng.standard_normal(sc.X.shape)
    path = str(tmp_path / "problem.bal")
    tio.save_bal(path, x, vis, X0, np.asarray(sc.R), np.asarray(sc.t),
                 np.asarray(sc.K[:, 0, 0]))
    prof = tmp_path / "prof"
    argv = ["bal", path, "--sparse", "--max-iter", "3", "--float64", "--device", "cpu",
            "--profile", str(prof)] + (["--shard-points", "1"] if shard else [])
    rec = _run(tcli.main, argv, capsys)
    spans = {"build", "state", "point_side", "camera_side", "matvec", "host_read"}
    assert set(rec["span_ms"]) == spans
    assert all(v > 0 for v in rec["span_ms"].values())
    assert rec["span_ms"]["state"] + rec["span_ms"]["point_side"] <= rec["span_ms"]["build"]
    names = {e.get("name") for e in json.loads((prof / TRACE_FILE).read_text())["traceEvents"]}
    assert spans <= names


def _flags(parser):
    """{subcommand: its option strings}."""
    sub = next(a for a in parser._actions if a.choices and isinstance(a.choices, dict))
    return {name: {s for a in p._actions for s in a.option_strings}
            for name, p in sub.choices.items()}


def test_jax_flags_parse_in_the_port():
    want, got = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert set(want) <= set(got)
    for name, flags in want.items():
        missing = flags - got[name] - UNPORTED_FLAGS
        assert not missing, f"{name}: {sorted(missing)}"
