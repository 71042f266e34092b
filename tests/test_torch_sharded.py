"""Point-sharded bundle adjustment of the PyTorch port on the CPU, in
float64, against the JAX package's sharded functions and the port's
unsharded cores.

- In process: ``pad_points`` against JAX's on numpy inputs; the shape
  rules of ``make_mesh``, ``scene_point_mesh`` and
  ``hybrid_scene_point_mesh`` against JAX's on its 8 virtual CPU devices
  for 1-8 ranks (the port's meshes over a fake process group of 8); an
  unbound axis name, lanes under an axis name and the paths of later
  slices raise.
- Spawned ranks: one group of 2 gloo ranks runs every case of ``CASES``
  once (this file is the rank program, under ``__main__``), and one
  group of 3 ranks the cases of ``CASES3``, whose last rank holds 60
  padding-like rows of its 67 (P = 199 pads to 201, and 58 more points
  are seen by no view). Each rank writes its results to an npz; each case
  is then its own test: against JAX's sharded function on a points mesh
  of as many devices (E rtol 1e-8, X atol 1e-7, K, R, t and the
  distortion atol 1e-8: JAX's bounds in ``tests/test_parallel.py``), the
  same iterations; against the port's unsharded core, to the same
  bounds; and every rank's result equal to rank 0's. The ranks also
  record that the chunked core took the non-fused build (K1's
  accumulation, one call per chunk and retry) under the axis name, and
  that no collective other than ``all_reduce`` and ``broadcast`` ran.

Hang guard: each group's ranks run with one torch thread, are killed
after ``RANK_TIMEOUT_S``, and a rendezvous port that is taken is retried
at most 3 times. JAX is imported only inside the test functions, so the
rank program never imports it.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
from mvrecon_tpu_torch.models import bundle_adjustment as tba
from mvrecon_tpu_torch.models import bundle_adjustment_chunked as tbc

REPO = pathlib.Path(__file__).resolve().parents[1]
AXIS = "x-up_z-forward"
RANK_TIMEOUT_S = 120
CHUNK = 25  # 5 chunks on each of 2 ranks, 3 on each of 3

# name: (core, data, mesh, LMConfig fields); data "radial" and "opencv" are
# the scene rendered through that distortion, "masked" a random 85 % of
# the observations, "padded" (3 ranks) the last rank's rows 7-64 unseen
CASES = {
    "dense": ("dense", "plain", "points",
              dict(scale_factor=2.0, delta_tol=1e-8, max_iter=10)),
    "dense_refit_huber": ("dense", "radial", "points",
                          dict(scale_factor=2.0, delta_tol=1e-8, max_iter=6,
                               distortion_rounds=1, robust="huber", huber_delta=0.01)),
    "chunked": ("chunked", "plain", "points",
                dict(scale_factor=2.0, delta_tol=1e-8, max_iter=8, damping="nielsen")),
    "chunked_opencv": ("chunked", "opencv", "points",
                       dict(scale_factor=2.0, delta_tol=1e-8, max_iter=6, damping="nielsen",
                            distortion_rounds=1, distortion_model="opencv")),
    "hybrid": ("dense", "masked", "hybrid", dict(scale_factor=2.0, delta_tol=1e-8, max_iter=6)),
    "lm_step": ("lm_step", "plain", "points", {}),
}
CASES3 = {
    "dense3": ("dense", "padded", "points",
               dict(scale_factor=2.0, delta_tol=1e-8, max_iter=8, damping="nielsen")),
    "chunked3": ("chunked", "padded", "points",
                 dict(scale_factor=2.0, delta_tol=1e-8, max_iter=8)),
}
GROUPS = {2: CASES, 3: CASES3}
OTHER_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
                     "all_to_all_single", "barrier", "batch_isend_irecv",
                     "broadcast_object_list", "gather", "gather_object", "irecv", "isend",
                     "monitored_barrier", "recv", "reduce", "reduce_scatter",
                     "reduce_scatter_tensor", "scatter", "scatter_object_list", "send")


def problem(case: str, world: int):
    """The case's global numpy inputs: (x (P, F, 2), X0, K, R, t0, vis or
    None, distortion truth or None). The curved tube of the port's
    ``geometry/scenes.py`` (12 views), cut to 201 points (199 for 3
    ranks), X and t perturbed by 0.02 N(0, 1) from a numpy seed."""
    _, data, _, _ = GROUPS[world][case]
    n = 199 if world == 3 else 201
    sc = make_synthetic_scene(torch.Generator().manual_seed(7), n_images=12, n_slices=11,
                              n_angles=20, dtype=torch.float64, noise=0.003)
    rng = np.random.default_rng(7)
    x = sc.x.transpose(0, 1)[:n].contiguous()
    nf = x.shape[1]
    truth = None
    if data in ("radial", "opencv"):
        truth = np.tile([-0.1, 0.02] if data == "radial" else [-0.1, 0.02, 0.004, -0.003],
                        (nf, 1))
        x = tba.distort_points(x, sc.K[:, 0, 0], None, 1.0, torch.from_numpy(truth))
    x = x.numpy().copy()
    if data == "radial":  # gross outliers for the Huber loss
        hit = rng.uniform(size=(n, nf)) < 0.02
        x[hit] += 0.2
    vis = None
    if data == "masked":
        vis = (rng.uniform(size=(n, nf)) > 0.15).astype(np.float64)
    elif data == "padded":
        vis = np.ones((n, nf))
        vis[141:] = 0.0  # the last rank's block is rows 134-200 of the padded 201
    X0 = sc.X.numpy()[:n] + 0.02 * rng.standard_normal((n, 3))
    t0 = sc.t.numpy() + 0.02 * rng.standard_normal(sc.t.shape)
    return x, X0, sc.K.numpy(), sc.R.numpy(), t0, vis, truth


def step_inputs(x, X0, R, t0):
    """The normalized state of ``sharded_lm_step``'s case as numpy fields
    (X, f, u, t, R), its 200 points' x and vis, and the gauge mask."""
    X, Rn, tn, _ = tba.normalize_gauge(*(torch.from_numpy(a) for a in (X0[:200], R, t0)), AXIS)
    f, u = tba.intrinsics_from_K(torch.eye(3, dtype=torch.float64).expand(12, 3, 3), 1.0)
    fields = [a.numpy().copy() for a in (X, f, u, tn, Rn)]
    return fields, x[:200], np.ones((200, 12)), tba.gauge_mask(12, AXIS, torch.float64).numpy()


def result_arrays(res) -> dict:
    out = {k: np.asarray(getattr(res, k)) for k in ("X", "K", "R", "t", "error", "n_iter")}
    if res.distortion is not None:
        out["distortion"] = np.asarray(res.distortion)
    return out


def run_port(case: str, world: int, mesh=None) -> dict:
    """The case through the port: sharded over ``mesh``, or unsharded when
    ``mesh`` is None. Unsharded, the pinhole chunked cases run the dense
    core: the chunked one would take its fused build, whose float64
    system is padded to 4608 columns (seconds a retry on one thread)."""
    from mvrecon_tpu_torch.parallel import sharded_ba as sba

    core, _, _, fields = GROUPS[world][case]
    x, X0, K, R, t0, vis, _ = problem(case, world)
    cfg = LMConfig(**fields)
    if core == "lm_step":
        (X, f, u, t, Rn), xs, vs, free = step_inputs(x, X0, R, t0)
        args = [torch.from_numpy(a) for a in (xs,)]
        state = tba.BAState(*(torch.from_numpy(a) for a in (X, f, u, t, Rn)))
        c = torch.tensor(1e-3, dtype=torch.float64)
        if mesh is None:
            new, e0, e1 = tba.lm_step(args[0], state, torch.from_numpy(vs),
                                      torch.from_numpy(free), 1.0, c)
        else:
            new, e0, e1 = sba.sharded_lm_step(mesh, xs, state, vs, free, c, device="cpu")
        return {**{k: getattr(new, k).numpy() for k in ("X", "f", "u", "t", "R")},
                "error": np.asarray(e1), "error_before": np.asarray(e0)}
    kw = dict(visibility=vis, axis=AXIS, config=cfg, device="cpu")
    if core == "chunked":
        kw["chunk_size"] = CHUNK
    if mesh is None:
        if core == "chunked" and "distortion_rounds" not in fields:
            core = "dense"
            del kw["chunk_size"]
        fn = tba.bundle_adjust if core == "dense" else tbc.bundle_adjust_chunked
        res = fn(x, X0, K, R, t0, **kw)
    else:
        fn = sba.sharded_bundle_adjust if core == "dense" else sba.sharded_bundle_adjust_chunked
        res = fn(mesh, x, X0, K, R, t0, **kw)
    out = result_arrays(res)
    if mesh is not None:
        out["log_keys"] = np.array(sorted(res.log) if res.log is not None else ["None"])
        if res.log is not None:
            out["retries"] = np.asarray(res.log["n_solver_retries"])
    return out


def run_jax(case: str, world: int) -> dict:
    """The case through JAX's sharded function on a points mesh of
    ``world`` devices (the hybrid case on a (1, world) mesh)."""
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.models.bundle_adjustment import BAState as JBAState
    from mvrecon_tpu.parallel import sharded_ba as jsba
    from mvrecon_tpu.parallel.mesh import hybrid_scene_point_mesh, make_mesh
    import jax

    core, _, mesh_kind, fields = GROUPS[world][case]
    x, X0, K, R, t0, vis, _ = problem(case, world)
    devices = jax.devices()[:world]
    mesh = (hybrid_scene_point_mesh(1, devices=devices) if mesh_kind == "hybrid"
            else make_mesh({"points": world}, devices=devices))
    if core == "lm_step":
        (X, f, u, t, Rn), xs, vs, free = step_inputs(x, X0, R, t0)
        step = jax.jit(lambda *a: jsba.sharded_lm_step(mesh, *a, 1.0))
        new, e0, e1 = step(jnp.asarray(xs), JBAState(*map(jnp.asarray, (X, f, u, t, Rn))),
                           jnp.asarray(vs), jnp.asarray(free), jnp.asarray(1e-3))
        return {**{k: np.asarray(getattr(new, k)) for k in ("X", "f", "u", "t", "R")},
                "error": np.asarray(e1), "error_before": np.asarray(e0)}
    args = [jnp.asarray(a) for a in (x, X0, K, R, t0)]
    kw = dict(f0=1.0, visibility=None if vis is None else jnp.asarray(vis), axis=AXIS,
              config=JLMConfig(**fields))
    if core == "dense":
        return result_arrays(jsba.sharded_bundle_adjust(mesh, *args, **kw))
    return result_arrays(jsba.sharded_bundle_adjust_chunked(mesh, *args, chunk_size=CHUNK, **kw))


# ------------------------------------------------------------ the ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, outdir: pathlib.Path) -> list[dict]:
    """Start ``world`` ranks of this file, wait at most ``RANK_TIMEOUT_S``
    (then kill them and fail), retry a taken port at most 3 times; the
    ranks' npz results."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    outs = []
    for _ in range(3):
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, __file__, str(port), str(r), str(world),
                                   str(outdir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0]
                    for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            outs = [p.communicate()[0] for p in procs]
            pytest.fail(f"{world} ranks passed {RANK_TIMEOUT_S} s:\n" + "\n".join(outs))
        if all(p.returncode == 0 for p in procs):
            return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]
        if not any("Address already in use" in o or "EADDRINUSE" in o for o in outs):
            break
    pytest.fail(f"{world} ranks failed:\n" + "\n".join(outs))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results on every rank: {world: [rank 0's, ...]}."""
    return {world: _launch(world, tmp_path_factory.mktemp(f"ranks{world}")) for world in GROUPS}


def _case(outputs: dict, case: str) -> dict:
    return {k.split(".", 1)[1]: v for k, v in outputs.items() if k.startswith(case + ".")}


ALL = [(2, c) for c in CASES] + [(3, c) for c in CASES3]


def _assert_close(got: dict, want: dict, case: str):
    assert got["X"].shape == want["X"].shape
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-8, err_msg=case)
    np.testing.assert_allclose(got["X"], want["X"], atol=1e-7, err_msg=case)
    for key in ("K", "R", "t", "f", "u", "distortion", "error_before"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-8, err_msg=f"{case} {key}")
    if "n_iter" in want:
        assert int(got["n_iter"]) == int(want["n_iter"]), case


@pytest.mark.parametrize("world,case", ALL, ids=[c for _, c in ALL])
def test_sharded_matches_jax(ranks, world, case):
    _assert_close(_case(ranks[world][0], case), run_jax(case, world), case)


@pytest.mark.parametrize("world,case", ALL, ids=[c for _, c in ALL])
def test_sharded_matches_unsharded(ranks, world, case):
    _assert_close(_case(ranks[world][0], case), run_port(case, world), case)


@pytest.mark.parametrize("world,case", ALL, ids=[c for _, c in ALL])
def test_every_rank_gets_the_global_result(ranks, world, case):
    """SPMD: every rank returns the same global arrays, bit for bit."""
    first = _case(ranks[world][0], case)
    for other in ranks[world][1:]:
        got = _case(other, case)
        assert got.keys() == first.keys()
        for k in first:
            np.testing.assert_array_equal(got[k], first[k], err_msg=f"{case} {k}")


def test_result_logs_are_jax_s(ranks):
    """The dense call returns ``log=None``, the chunked one
    {"n_solver_retries", "c", "nu"}; distortion only when modelled."""
    out = ranks[2][0]
    assert list(out["dense.log_keys"]) == ["None"]
    assert list(out["chunked.log_keys"]) == ["c", "n_solver_retries", "nu"]
    assert "chunked.distortion" not in out and "dense.distortion" not in out
    assert out["chunked_opencv.distortion"].shape == (12, 4)
    assert out["dense_refit_huber.distortion"].shape == (12, 2)


@pytest.mark.parametrize("world,case", [(2, "chunked"), (3, "chunked3")])
def test_chunked_core_takes_the_nonfused_build(ranks, world, case):
    """Under the axis name the pinhole chunked core, which runs the fused
    build on one device, takes the non-fused build: K1's accumulation once
    per chunk and retry on every rank, no fused build."""
    for out in ranks[world]:
        n_chunks = -(-int(out["meta.rows_per_rank"]) // CHUNK)
        assert int(out[f"{case}.fused_builds"]) == 0
        assert int(out[f"{case}.k1_calls"]) == int(out[f"{case}.retries"]) * n_chunks > 0


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_shard_feeding_round_trips(ranks, world):
    """``distribute_array`` then ``gather_array`` over the points axis, and
    ``replicate_array``, give back the global array on every rank."""
    for out in ranks[world]:
        assert bool(out["meta.round_trip"])


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_only_all_reduce_and_broadcast(ranks, world):
    """No collective other than ``all_reduce`` (sum) and ``broadcast`` was
    called while the sharded functions ran; all_reduce was."""
    for out in ranks[world]:
        assert list(out["meta.other_collectives"]) == []
        assert int(out["meta.all_reduce_calls"]) > 0


# ------------------------------------------------------------ in process


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_pad_points_matches_jax(n_shards):
    import jax.numpy as jnp

    from mvrecon_tpu.parallel.sharded_ba import pad_points as jpad
    from mvrecon_tpu_torch.parallel.sharded_ba import pad_points

    rng = np.random.default_rng(n_shards)
    x, X, vis = rng.standard_normal((10, 3, 2)), rng.standard_normal((10, 3)), np.ones((10, 3))
    want = jpad(jnp.asarray(x), jnp.asarray(X), jnp.asarray(vis), n_shards)
    got = pad_points(x, X, vis, n_shards)
    assert got[3] == want[3] == 10
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15, atol=0)


@pytest.fixture
def fake_world():
    """A fake process group of 8 ranks in this process (rank 0): the
    meshes' process groups exist, and no collective runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _layout(mesh) -> tuple[dict, list]:
    """(shape dict, device ids) of a JAX mesh or the port's DeviceMesh."""
    if hasattr(mesh, "devices"):
        return dict(mesh.shape), [[d.id for d in row] for row in np.atleast_2d(mesh.devices)]
    from mvrecon_tpu_torch.parallel.mesh import mesh_shape

    return mesh_shape(mesh), np.atleast_2d(mesh.mesh.numpy()).tolist()


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_rules_match_jax(fake_world, n):
    import jax

    from mvrecon_tpu.parallel import mesh as jmesh
    from mvrecon_tpu_torch.parallel import mesh as tmesh

    jdev, ranks = jax.devices()[:n], list(range(n))
    assert _layout(tmesh.make_mesh({"points": n})) == _layout(jmesh.make_mesh({"points": n}))
    assert (_layout(tmesh.scene_point_mesh(n)) == _layout(jmesh.scene_point_mesh(n)))
    assert (_layout(tmesh.make_mesh({"scenes": 1, "points": n}, devices=ranks))
            == _layout(jmesh.make_mesh({"scenes": 1, "points": n}, devices=jdev)))
    for k in range(1, n + 1):
        if n % k:
            with pytest.raises(ValueError, match="slices"):
                jmesh.hybrid_scene_point_mesh(k, devices=jdev)
            with pytest.raises(ValueError, match="slices"):
                tmesh.hybrid_scene_point_mesh(k, devices=ranks)
        else:
            assert (_layout(tmesh.hybrid_scene_point_mesh(k, devices=ranks))
                    == _layout(jmesh.hybrid_scene_point_mesh(k, devices=jdev)))
    with pytest.raises(ValueError, match=f"mesh needs {n + 1} devices, have {n}"):
        tmesh.make_mesh({"points": n + 1}, devices=ranks)


def test_process_meshes_match_jax(fake_world):
    """One host holding every rank: ``process_scene_point_mesh`` is (1, 8)
    and ``points_mesh`` (8,), as JAX's are for one process of 8 devices."""
    from mvrecon_tpu.runtime import distributed as jdist
    from mvrecon_tpu_torch.runtime import distributed as tdist

    assert _layout(tdist.process_scene_point_mesh()) == _layout(jdist.process_scene_point_mesh())
    assert _layout(tdist.points_mesh()) == _layout(jdist.points_mesh())


def test_axis_name_errors():
    """An axis name no sharded call binds raises ``ValueError``, as do
    lanes under an axis name; the sparse core's ``axis_name``, the solver
    hook, ``euclidean_reconstruction_large(mesh=)`` and ``bal
    --shard-points`` raise ``NotImplementedError`` naming their slice."""
    from mvrecon_tpu_torch.__main__ import main
    from mvrecon_tpu_torch.models.bundle_adjustment_sparse import lm_optimize_sparse
    from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction_large

    x, X0, K, R, t0, _, _ = problem("dense", 2)
    (X, f, u, t, Rn), xs, vs, free = step_inputs(x, X0, R, t0)
    state = tba.BAState(*(torch.from_numpy(a) for a in (X, f, u, t, Rn)))
    targs = (torch.from_numpy(xs), state, torch.from_numpy(vs), torch.from_numpy(free), 1.0)
    with pytest.raises(ValueError, match="not bound"):
        tba.lm_step(*targs, torch.tensor(1e-3, dtype=torch.float64), "points")
    lanes = tba.BAState(*(a[None] for a in state))
    with pytest.raises(ValueError, match="one problem"):
        tba.lm_lanes(targs[0], lanes, *targs[2:], LMConfig(), axis_name="points")
    with pytest.raises(NotImplementedError, match="item 4d"):
        lm_optimize_sparse(None, state, targs[3], 1.0, LMConfig(), axis_name="points")
    with pytest.raises(NotImplementedError, match="item 4d"):
        tba.lm_optimize(*targs, LMConfig(), solver=tba._damped_solve)
    with pytest.raises(NotImplementedError, match="item 4b"):
        euclidean_reconstruction_large(x.transpose(1, 0, 2), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 4d"):
        main(["bal", "unused.bal", "--shard-points", "2", "--device", "cpu"])


def test_initialize_backend_rules():
    """The backend follows the device: NCCL is refused for the CPU, and an
    unknown backend or platform raises, before any rendezvous."""
    from mvrecon_tpu_torch.runtime.distributed import initialize

    with pytest.raises(ValueError, match="NCCL carries no CPU tensors"):
        initialize("localhost:1", 1, 0, platform="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        initialize("localhost:1", 1, 0, platform="cpu", backend="mpi")
    with pytest.raises(ValueError, match="unknown platform"):
        initialize("localhost:1", 1, 0, platform="tpu")


def test_initialize_needs_nccl_for_a_card(monkeypatch):
    """A card takes NCCL: a PyTorch without it raises rather than falling
    back to gloo unasked."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.runtime.distributed import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="takes NCCL"):
        initialize("localhost:1", 1, 0)


# ------------------------------------------------------------ rank program


def _guard_collectives(record: dict) -> None:
    """Count ``all_reduce`` calls (sum only) and record any other
    collective called through ``torch.distributed``."""
    import torch.distributed as dist

    all_reduce = dist.all_reduce

    def counted(tensor, op=dist.ReduceOp.SUM, *args, **kwargs):
        if op != dist.ReduceOp.SUM:
            record["other"].append(f"all_reduce({op})")
        record["all_reduce"] += 1
        return all_reduce(tensor, op, *args, **kwargs)

    def refused(name):
        def call(*args, **kwargs):
            record["other"].append(name)
            raise RuntimeError(f"collective {name} called")
        return call

    dist.all_reduce = counted
    for name in OTHER_COLLECTIVES:
        if hasattr(dist, name):
            setattr(dist, name, refused(name))


def _rank_main(port: int, rank: int, world: int, outdir: str) -> None:
    from mvrecon_tpu_torch.parallel.mesh import hybrid_scene_point_mesh, make_mesh
    from mvrecon_tpu_torch.runtime.distributed import (
        distribute_array,
        gather_array,
        initialize,
        replicate_array,
    )

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", world, rank, platform="cpu")
    meshes = {"points": make_mesh({"points": world}), "hybrid": hybrid_scene_point_mesh(1)}
    record = {"all_reduce": 0, "other": []}
    _guard_collectives(record)
    counts = {"k1": 0, "fused": 0}
    accumulate, fused = tbc.syrk_lower_accumulate, tbc._build_system_fused

    def counted_accumulate(*args, **kwargs):
        counts["k1"] += 1
        return accumulate(*args, **kwargs)

    def counted_fused(*args, **kwargs):
        counts["fused"] += 1
        return fused(*args, **kwargs)

    tbc.syrk_lower_accumulate, tbc._build_system_fused = counted_accumulate, counted_fused
    arr = np.arange(world * 5 * 2, dtype=np.float64).reshape(world * 5, 2)
    block = distribute_array(meshes["points"], ("points",), arr, "cpu")
    out = {"meta.round_trip": np.asarray(
        block.shape == (5, 2)
        and np.array_equal(gather_array(meshes["points"], block, ("points",)).numpy(), arr)
        and np.array_equal(replicate_array(meshes["points"], arr, "cpu").numpy(), arr))}
    for case, (_, _, mesh_kind, _) in GROUPS[world].items():
        counts.update(k1=0, fused=0)
        res = run_port(case, world, meshes[mesh_kind])
        res.update(k1_calls=counts["k1"], fused_builds=counts["fused"])
        out.update({f"{case}.{k}": v for k, v in res.items()})
    n_pad = 199 if world == 3 else 201
    out["meta.rows_per_rank"] = np.asarray(-(-n_pad // world))
    out["meta.all_reduce_calls"] = np.asarray(record["all_reduce"])
    out["meta.other_collectives"] = np.array(record["other"], dtype=str)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
