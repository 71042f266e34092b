"""Structural rules of the PyTorch port, checked on its sources:

- no module of ``mvrecon_tpu_torch``, and neither ``chip_smoke.py`` nor
  the port's scripts that run on the card, imports JAX or the JAX package (checked on the AST: the interpreter may have
  JAX loaded already, so ``sys.modules`` proves nothing);
- entry points run on the card by default and raise without one, the
  ``bal`` subcommand, the sharded cores and ``initialize`` too;
- the port's ``runtime/io.py`` imports numpy and the standard library
  only;
- the kernel wrappers ``syrk_acc`` and ``syrk_lower`` have no ``try``
  around their launch and take the plain version only for CPU tensors.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mvrecon_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "scripts" / "profile_torch_ba.py",
    REPO / "scripts" / "profile_torch_streamed.py",
    REPO / "scripts" / "gpu_cpu_trajectory.py",
    REPO / "scripts" / "eigh_batch_limit.py",
    REPO / "scripts" / "dense_wall.py",
    REPO / "scripts" / "sparse_reductions.py",
]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path.name} imports {mod}"
        assert top != "mvrecon_tpu", f"{path.name} imports {mod}"


def test_entry_points_default_to_the_card(monkeypatch):
    from mvrecon_tpu_torch.models.bundle_adjustment import bundle_adjust
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.covariance import (
        ba_covariance,
        ba_covariance_chunked,
        ba_covariance_streamed,
    )
    from mvrecon_tpu_torch.models.perspective import perspective_self_calibration
    from mvrecon_tpu_torch.models.affine import affine_self_calibration
    from mvrecon_tpu_torch.models.pipelines import (
        affine_reconstruction,
        euclidean_reconstruction,
        euclidean_reconstruction_large,
    )
    from mvrecon_tpu_torch.parallel.batched import (
        batched_affine_reconstruction,
        batched_euclidean_reconstruction,
        batched_euclidean_to_convergence,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 20, 2))
    start = (np.zeros((20, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3)))
    for fn, args in ((affine_reconstruction, (x, np.ones(4))),
                     (affine_self_calibration, (x, "orthographic")),
                     (batched_affine_reconstruction, (x[None], np.ones((1, 4)))),
                     (batched_euclidean_reconstruction, (x[None],)),
                     (batched_euclidean_to_convergence, (x[None],))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        euclidean_reconstruction_large(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        euclidean_reconstruction(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perspective_self_calibration(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust_chunked(x.transpose(1, 0, 2), *start)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust(x.transpose(1, 0, 2), *start)
    for fn in (ba_covariance, ba_covariance_chunked, ba_covariance_streamed):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x.transpose(1, 0, 2), *start)


def test_sharded_entry_points_default_to_the_card(monkeypatch):
    """``initialize`` and the sharded cores run on the card unless asked,
    and raise without one (the mesh over a fake one-rank process group)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from mvrecon_tpu_torch.models.bundle_adjustment import BAState
    from mvrecon_tpu_torch.parallel import (
        make_mesh,
        sharded_ba_covariance,
        sharded_bundle_adjust,
        sharded_bundle_adjust_chunked,
        sharded_euclidean_reconstruction,
        sharded_lm_step,
    )
    from mvrecon_tpu_torch.parallel.sharded_ba_2d import sharded_bundle_adjust_2d
    from mvrecon_tpu_torch.parallel.sharded_calibration import (
        sharded_perspective_self_calibration,
    )
    from mvrecon_tpu_torch.runtime.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("localhost:1", 1, 0)
    x = np.zeros((20, 4, 2))
    start = (np.zeros((20, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3)))
    state = BAState(*(torch.zeros(s) for s in ((20, 3), (4,), (4, 2), (4, 3), (4, 3, 3))))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh({"points": 1})
        mesh_2d = make_mesh({"points": 1, "cameras": 1})
        calls = [lambda: sharded_bundle_adjust(mesh, x, *start),
                 lambda: sharded_bundle_adjust_2d(mesh_2d, x, *start),
                 lambda: sharded_bundle_adjust_chunked(mesh, x, *start),
                 lambda: sharded_lm_step(mesh, x, state, np.ones((20, 4)), np.ones(36), 1e-3),
                 lambda: sharded_ba_covariance(mesh, x, *start),
                 lambda: sharded_perspective_self_calibration(mesh, x.transpose(1, 0, 2)),
                 lambda: sharded_euclidean_reconstruction(mesh, x.transpose(1, 0, 2))]
        for call in calls:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    finally:
        dist.destroy_process_group()


def _function(tree, name):
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _assert_launches_or_raises(module, wrapper, reference):
    tree = ast.parse((PORT / "ops" / module).read_text())
    fn = _function(tree, wrapper)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    # the one call of the plain version sits under a test of the device
    # type against "cpu"
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.If)
             and any(isinstance(c, ast.Call) and getattr(c.func, "id", "") == reference
                     for s in n.body for c in ast.walk(s))]
    assert len(calls) == 1
    test_src = ast.unparse(calls[0].test)
    assert 'device.type == "cpu"' in test_src.replace("'", '"')
    assert "os.environ" not in ast.unparse(fn)


def test_syrk_acc_launches_or_raises():
    _assert_launches_or_raises("fused_schur.py", "syrk_acc", "syrk_acc_reference")


def test_syrk_lower_launches_or_raises():
    _assert_launches_or_raises("syrk.py", "syrk_lower", "syrk_lower_reference")


def test_streamed_entry_point_defaults_to_the_card(monkeypatch):
    from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust_streamed(np.zeros((20, 4, 2)), np.zeros((20, 3)), np.zeros((4, 3, 3)),
                               np.zeros((4, 3, 3)), np.zeros((4, 3)))


def test_cli_runs_on_cpu(capsys):
    from mvrecon_tpu_torch.__main__ import main

    assert main(["euclidean-large", "--n-points", "100", "--n-images", "6",
                 "--chunk-size", "64", "--max-iter", "2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_points"] == 100 and rec["n_views"] == 6 and rec["device"] == "cpu"
    assert rec["status"] == 0 and np.isfinite(rec["reprojection_error"])


def test_euclidean_cli_runs_on_cpu(capsys):
    from mvrecon_tpu_torch.__main__ import main

    assert main(["euclidean", "--n-points", "200", "--n-images", "8", "--eig-method", "power",
                 "--device", "cpu", "--float64"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["command"] == "euclidean" and rec["eig_method"] == "power"
    assert rec["n_points"] == 200 and rec["n_views"] == 8 and rec["device"] == "cpu"
    assert rec["dtype"] == "float64" and rec["status"] == 0 and rec["ba_iterations"] > 0
    assert set(rec["stage_walls_s"]) == {"perspective_self_calibration", "bundle_adjustment"}
    assert rec["E_vs_noise_floor"] < 1.5


def test_bal_defaults_to_the_card(monkeypatch, tmp_path):
    from mvrecon_tpu_torch.__main__ import main
    from mvrecon_tpu_torch.runtime.io import save_bal

    rng = np.random.default_rng(0)
    path = str(tmp_path / "problem.bal")
    save_bal(path, rng.standard_normal((3, 5, 2)), np.ones((5, 3)), rng.standard_normal((5, 3)),
             np.broadcast_to(np.eye(3), (3, 3, 3)), rng.standard_normal((3, 3)), np.ones(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bal", path])


def test_sparse_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import (
        bundle_adjust_sparse,
        dense_to_sparse_obs,
        make_sparse_obs,
    )
    from mvrecon_tpu_torch.ops.triangulation import triangulate_sparse
    from mvrecon_tpu_torch.runtime.elastic import resumable_bundle_adjust_sparse

    obs = make_sparse_obs(np.arange(4), np.arange(4) % 2, np.zeros((4, 2)), device="cpu")
    start = (np.zeros((4, 3)), np.broadcast_to(np.eye(3), (2, 3, 3)),
             np.broadcast_to(np.eye(3), (2, 3, 3)), np.zeros((2, 3)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sparse_obs(np.arange(4), np.arange(4) % 2, np.zeros((4, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dense_to_sparse_obs(np.zeros((4, 2, 2)), np.ones((4, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle_adjust_sparse(obs, *start)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        triangulate_sparse(np.arange(4), np.arange(4) % 2, np.zeros((4, 2)), 4, *start[1:])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resumable_bundle_adjust_sparse(obs, *start, str(tmp_path / "c.npz"), total_iters=1)


def test_bal_sparse_defaults_to_the_card(monkeypatch, tmp_path):
    from mvrecon_tpu_torch.__main__ import main
    from mvrecon_tpu_torch.runtime.io import save_bal_sparse

    rng = np.random.default_rng(0)
    path = str(tmp_path / "problem.bal")
    save_bal_sparse(path, np.repeat(np.arange(5), 3), np.tile(np.arange(3), 5),
                    rng.standard_normal((15, 2)), 5, rng.standard_normal((5, 3)),
                    np.broadcast_to(np.eye(3), (3, 3, 3)), rng.standard_normal((3, 3)),
                    np.ones(3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["bal", path, "--sparse"])


def test_io_imports_numpy_and_the_standard_library_only():
    mods = {m.split(".")[0] for m in _imported_modules(PORT / "runtime" / "io.py")}
    assert mods <= {"__future__", "typing", "os", "struct", "numpy"}, mods


def test_cli_and_compat_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``reconstruct``, ``bench-ba``, ``BundleAdjuster`` and the other
    reference-named shims run on the card unless asked, and raise without
    one."""
    from mvrecon_tpu_torch import (
        affine_camera_calibration,
        camera,
        factorization,
        perspective_camera_calibration,
        ops,
        utils,
    )
    from mvrecon_tpu_torch.__main__ import main
    from mvrecon_tpu_torch.bundle_adjustment import BundleAdjuster
    from mvrecon_tpu_torch.runtime.io import save_observations

    path = str(tmp_path / "tracks.npz")
    save_observations(path, np.zeros((4, 20, 2)))
    x = np.zeros((4, 20, 2))
    start = (np.zeros((20, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3, 3)), np.zeros((4, 3)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: main(["reconstruct", path]),
        lambda: main(["bench-ba", "--points", "40", "--views", "4"]),
        lambda: BundleAdjuster(x.transpose(1, 0, 2), *start),
        lambda: camera.Camera(np.eye(3), np.zeros(3)),
        lambda: camera.Camera.create(),
        lambda: camera.calc_projected_points(*start[:1], *start[1:]),
        lambda: utils.set_points(),
        lambda: utils.get_rotation_matrix(np.zeros(3)),
        lambda: factorization.factorization_method(np.zeros((8, 20))),
        lambda: affine_camera_calibration.orthographic_self_calibration(x),
        lambda: ops.triangulate(x, *start[1:]),
        lambda: perspective_camera_calibration.perspective_self_calibration_full(list(x)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
