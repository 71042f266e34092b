"""Point-sharded bundle adjustment (dense, chunked and sparse cores),
calibration (perspective and affine), covariance and pipelines of the
PyTorch port on the CPU, in float64, against the JAX package's sharded
functions and the port's unsharded ones.

- In process: ``pad_points`` and ``partition_sparse_obs`` against JAX's on
  numpy inputs; the shape rules of ``make_mesh``, ``scene_point_mesh`` and
  ``hybrid_scene_point_mesh`` against JAX's on its 8 virtual CPU devices
  for 1-8 ranks (the port's meshes over a fake process group of 8), and
  ``shard_scenes``'s block on that group; an unbound axis name, lanes
  under an axis name, the 2D solver without a bound ``cameras`` axis, an
  indivisible P under the affine calibration, and an indivisible F or an
  unknown matvec mode under the 2D BA raise.
- Spawned ranks: one group of 2 gloo ranks runs every case of ``CASES``
  once (this file is the rank program, under ``__main__``), one group of
  3 ranks the cases of ``CASES3``, whose last rank holds 60 padding-like
  rows of its 67 (P = 199 pads to 201, and 58 more points are seen by no
  view), and one group of 4 ranks the 2D BA on a 2 x 2 mesh
  (``CASES4``). Each rank writes its results to an npz; each case
  is then its own test: against JAX's sharded function on a points mesh
  of as many devices (E rtol 1e-8, X atol 1e-7, K, R, t and the
  distortion atol 1e-8: JAX's bounds in ``tests/test_parallel.py``), the
  same iterations; against the port's unsharded core, to the same
  bounds; and every rank's result equal to rank 0's. The ranks also
  record that the chunked core took the non-fused build (K1's
  accumulation, one call per chunk and retry) under the axis name, and
  each case's collectives: ``all_reduce`` (sum) and ``broadcast`` only,
  but for the 2D cases.
- The 2D (points x cameras) BA, ``sharded_bundle_adjust_2d``, on 1 x 2
  (both matvec modes, and ring with two Huber-weighted radial refits),
  2 x 1, 1 x 3 (ring) and 2 x 2 (both modes) meshes: against JAX's on a
  mesh of the same shape, computed once in a module fixture (E rtol
  1e-8, X atol 1e-6, K, R, t atol 1e-7; the refit case E rtol 1e-6,
  aligned RMSE < 1e-5, the distortion atol 5e-3), and against the port's
  1D ``sharded_bundle_adjust`` on the same ranks at JAX's 2D-against-1D
  bounds; sum and max all-reduces, and ``batch_isend_irecv`` in ring mode
  alone. Every group also round-trips ``all_gather_axis`` and
  ``ppermute_axis`` on a ``cameras`` mesh of its ranks.
- The same two groups run the sharded calibration (dual, its chunked
  Khatri–Rao branch with ``_KR_CHUNK_BYTES`` lowered inside the ranks,
  primary on 3 ranks), the sharded perspective pipeline (plain, masked,
  on a hybrid mesh), the large pipeline with a mesh, the sharded
  covariance (plain, and masked with Huber and a radial distortion; on 3
  ranks padded), the sharded sparse core (stored with the E curve,
  recompute at ``obs_chunk=173``, Huber with a radial refit; on 3 ranks P
  = 199, so the last rank holds two padded points: JAX's bounds in
  ``tests/test_ba_sparse.py``), the affine calibration per model and the
  affine pipeline, ``shard_scenes`` over a scenes mesh, and the commands
  ``euclidean``, ``affine``, ``reconstruct`` and ``bal`` (dense, chunked
  and ``--sparse``) with ``--shard-points 2`` through ``cli.main``, on
  files the fixture writes; ``euclidean`` and ``affine`` draw their scene
  on rank 0 alone. Perspective calibrations and pipelines are compared up
  to one global rotation of the frame, taken from camera 0 (the
  eigenvector signs of the two backends' eigensolvers may turn the
  calibrated frame; JAX's own ``tests/test_parallel.py`` compares so); the
  affine ones pin their signs.

Hang guard: each group's ranks run with one torch thread, are killed
after ``RANK_TIMEOUT_S``, and a rendezvous port that is taken is retried
at most 3 times. JAX is imported only inside the test functions, so the
rank program never imports it.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
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
from mvrecon_tpu_torch.runtime.distributed import free_port

REPO = pathlib.Path(__file__).resolve().parents[1]
AXIS = "x-up_z-forward"
RANK_TIMEOUT_S = 120
CHUNK = 25  # 5 chunks on each of 2 ranks, 3 on each of 3
# the sparse cases: tests/test_ba_sparse.py's schedule and CG tolerance
SPARSE_CFG = dict(scale_factor=4.0, delta_tol=0.0, max_iter=3, accept_divisor=1.0,
                  init_damping=3e-3, damping="nielsen")
SPARSE_KW = dict(cg_tol=1e-12, cg_max_iter=500)
# the 2D cases: JAX's schedule in tests/test_parallel.py with the damping
# started at 1e-2 and 4 iterations, so that CG at cg_tol=1e-12 converges
# in 101-250 iterations a solve (107-371 in the refit case; at the default
# 1e-4 it takes 451-1244 on this tube, past JAX's cap of 200, and the
# result then rests on rounding); the cap is never reached
TWO_D_CFG = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=4, init_damping=1e-2)
TWO_D_KW = dict(cg_tol=1e-12, cg_max_iter=2000)

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
    # calibration and pipeline data: the tube with 10 or 8 views cut to 200
    # points (201 on 3 ranks); "kr" 512 points x 6 views, run with the
    # Khatri–Rao budget at KR_CHUNK points (``kr_budget``)
    "calib_dual": ("calib", "tube10", "points", dict(method="dual", tol=1e-2)),
    "calib_dual_kr": ("calib", "kr", "points", dict(method="dual", tol=1e-2)),
    "pipeline": ("pipeline", "tube8", "points", dict(max_iter=12)),
    "pipeline_masked": ("pipeline", "tube8+masked", "points", dict(max_iter=12)),
    "pipeline_hybrid": ("pipeline", "tube8", "hybrid", dict(max_iter=8)),
    # the large pipeline's default schedule, cut to 2 iterations
    "large": ("large", "large", "points", dict(scale_factor=4.0, delta_tol=0.0, max_iter=2,
                                               accept_divisor=1.0, init_damping=3e-3,
                                               damping="nielsen")),
    "covariance": ("covariance", "plain", "points", {}),
    "covariance_robust": ("covariance", "radial+masked", "points",
                          dict(robust="huber", huber_delta=0.05)),
    # commands: argv beside --shard-points 2 --device cpu; {dir} is the
    # ranks' directory, where the fixture writes tracks.npz and problem.bal
    "cli_euclidean": ("cli", "none", "points", dict(argv=["euclidean", "--n-images", "8",
                                                          "--float64"])),
    "cli_reconstruct": ("cli", "tracks", "points", dict(argv=[
        "reconstruct", "{dir}/tracks.npz", "--float64", "--output", "{dir}/reconstruct.npz",
        "--log-json", "{dir}/reconstruct.jsonl"])),
    "cli_bal": ("cli", "bal", "points", dict(argv=["bal", "{dir}/problem.bal", "--float64",
                                                   "--max-iter", "10"])),
    "cli_bal_chunked": ("cli", "bal", "points", dict(argv=[
        "bal", "{dir}/problem.bal", "--float64", "--max-iter", "8", "--chunk-size", "25"])),
    "cli_affine": ("cli", "none", "points", dict(argv=["affine", "--n-images", "8",
                                                       "--float64"])),
    "cli_bal_sparse": ("cli", "bal", "points", dict(argv=[
        "bal", "{dir}/problem.bal", "--sparse", "--float64", "--max-iter", "5", "--huber",
        "0.05", "--optimize-distortion", "1", "--cg-max-iter", "60"])),
    # the sparse core on the observation list of the data's visible
    # entries, LMConfig fields beside the core's keywords ("kw"); stored
    # with the E curve, recompute, and Huber with one radial refit
    "sparse": ("sparse", "masked", "points", dict(SPARSE_CFG, record_log=True)),
    "sparse_recompute": ("sparse", "masked", "points",
                         dict(SPARSE_CFG, kw=dict(factor_mode="recompute", obs_chunk=173))),
    "sparse_huber_refit": ("sparse", "radial+masked", "points",
                           dict(SPARSE_CFG, robust="huber", huber_delta=0.01,
                                distortion_rounds=1)),
    # affine calibration per model and the affine pipeline: the 12-view tube
    "affine_orthographic": ("affine", "tube12", "points", dict(model="orthographic")),
    "affine_symmetric": ("affine", "tube12", "points", dict(model="symmetric")),
    "affine_paraperspective": ("affine", "tube12", "points", dict(model="paraperspective")),
    "affine_pipeline": ("affine_pipeline", "tube12", "points", dict(max_iter=12)),
    # the 2D BA on "PxC" meshes (points x cameras), LMConfig fields beside
    # its keywords ("kw"); P = 201 pads to 202 on 2 points ranks
    "2d_gather": ("2d", "plain", "1x2",
                  dict(TWO_D_CFG, kw=dict(TWO_D_KW, matvec_mode="all_gather"))),
    "2d_ring": ("2d", "plain", "1x2", dict(TWO_D_CFG, kw=dict(TWO_D_KW, matvec_mode="ring"))),
    "2d_points": ("2d", "plain", "2x1",
                  dict(TWO_D_CFG, kw=dict(TWO_D_KW, matvec_mode="all_gather"))),
    "2d_ring_refit_huber": ("2d", "radial", "1x2",
                            dict(TWO_D_CFG, max_iter=2, delta_tol=1e-10, distortion_rounds=2,
                                 robust="huber", huber_delta=0.01,
                                 kw=dict(TWO_D_KW, matvec_mode="ring"))),
}
CASES3 = {
    "dense3": ("dense", "padded", "points",
               dict(scale_factor=2.0, delta_tol=1e-8, max_iter=8, damping="nielsen")),
    "chunked3": ("chunked", "padded", "points",
                 dict(scale_factor=2.0, delta_tol=1e-8, max_iter=8)),
    "calib_primary3": ("calib", "tube8", "points", dict(method="primary", tol=5e-2)),
    "covariance3": ("covariance", "padded", "points", {}),
    "covariance_robust3": ("covariance", "radial+padded", "points",
                           dict(robust="huber", huber_delta=0.05)),
    # P = 199: the last rank holds 65 points and 2 padded ones, and only 7
    # of its points are seen
    "sparse3": ("sparse", "padded", "points", dict(SPARSE_CFG)),
    "2d_ring3": ("2d", "plain", "1x3", dict(TWO_D_CFG, kw=dict(TWO_D_KW, matvec_mode="ring"))),
}
# 4 ranks: the one mesh where both axes of the 2D BA carry traffic
CASES4 = {
    "2d_gather4": ("2d", "plain", "2x2",
                   dict(TWO_D_CFG, kw=dict(TWO_D_KW, matvec_mode="all_gather"))),
    "2d_ring4": ("2d", "plain", "2x2", dict(TWO_D_CFG, kw=dict(TWO_D_KW, matvec_mode="ring"))),
}
GROUPS = {2: CASES, 3: CASES3, 4: CASES4}
BA_CORES = ("dense", "chunked", "lm_step")
NEW_CORES = ("sparse", "affine", "affine_pipeline")
KR_CHUNK = 128  # "kr": 256 points a rank, so two chunks a rank, four unsharded
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
    data = set(GROUPS[world][case][1].split("+"))
    n = 199 if world == 3 else 201
    sc = make_synthetic_scene(torch.Generator().manual_seed(7), n_images=12, n_slices=11,
                              n_angles=20, dtype=torch.float64, noise=0.003)
    rng = np.random.default_rng(7)
    x = sc.x.transpose(0, 1)[:n].contiguous()
    nf = x.shape[1]
    truth = None
    if data & {"radial", "opencv"}:
        truth = np.tile([-0.1, 0.02] if "radial" in data else [-0.1, 0.02, 0.004, -0.003],
                        (nf, 1))
        x = tba.distort_points(x, sc.K[:, 0, 0], None, 1.0, torch.from_numpy(truth))
    x = x.numpy().copy()
    if "radial" in data:  # gross outliers for the Huber loss
        hit = rng.uniform(size=(n, nf)) < 0.02
        x[hit] += 0.2
    vis = None
    if "masked" in data:
        vis = (rng.uniform(size=(n, nf)) > 0.15).astype(np.float64)
    elif "padded" in data:
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


def two_d_inputs(case: str, world: int):
    """A 2D case's numpy inputs (``problem``), LMConfig fields and the
    core's keywords."""
    fields = dict(GROUPS[world][case][3])
    kw = fields.pop("kw")
    return problem(case, world), fields, kw


def run_port_2d(case: str, world: int, mesh, points_mesh) -> dict:
    """A 2D case through the port's ``sharded_bundle_adjust_2d`` on
    ``mesh``, and through the 1D ``sharded_bundle_adjust`` on
    ``points_mesh`` (keys "1d_*")."""
    from mvrecon_tpu_torch.parallel import sharded_ba as sba
    from mvrecon_tpu_torch.parallel.sharded_ba_2d import sharded_bundle_adjust_2d

    (x, X0, K, R, t0, vis, _), fields, kw = two_d_inputs(case, world)
    common = dict(visibility=vis, axis=AXIS, config=LMConfig(**fields), device="cpu")
    out = result_arrays(sharded_bundle_adjust_2d(mesh, x, X0, K, R, t0, **common, **kw))
    ref = result_arrays(sba.sharded_bundle_adjust(points_mesh, x, X0, K, R, t0, **common))
    return {**out, **{f"1d_{k}": v for k, v in ref.items()}}


def mesh_axes(kind: str) -> dict:
    """The axis sizes of a 2D case's mesh kind "PxC"."""
    points, cameras = map(int, kind.split("x"))
    return {"points": points, "cameras": cameras}


def tube(case: str, world: int):
    """Observations x (F, P, 2) of a calibration or pipeline case and its
    visibility (P, F) or None: the tube with 10 or 8 views cut to 200
    points (201 on 3 ranks), "masked" 15 % unseen; "kr" 512 points x 6
    views; "large" 400 points x 12 views (``tests/test_torch_pipeline.py``'s
    size)."""
    data = GROUPS[world][case][1].split("+")
    if data[0] == "kr":
        sc = make_synthetic_scene(torch.Generator().manual_seed(11), n_images=6, n_slices=16,
                                  n_angles=32, dtype=torch.float64, noise=0.003)
        return sc.x.numpy(), None
    if data[0] == "large":
        sc = make_synthetic_scene(torch.Generator().manual_seed(2), n_images=12, n_slices=20,
                                  n_angles=20, dtype=torch.float64)
        return sc.x.numpy(), None
    sc = make_synthetic_scene(torch.Generator().manual_seed(5), n_images=int(data[0][4:]),
                              n_slices=11, n_angles=20, dtype=torch.float64)
    x = sc.x.numpy()[:, :201 if world == 3 else 200]
    vis = None
    if "masked" in data:
        vis = (np.random.default_rng(5).uniform(size=x.shape[1::-1]) > 0.15).astype(np.float64)
        vis[:, :2] = 1.0
    return np.ascontiguousarray(x), vis


def tracks_file(path):
    """``cli_reconstruct``'s npz: the 8-view tube's 200 points with three
    observations moved by 0.08-0.12 and masked out in ``visibility``."""
    from mvrecon_tpu_torch.runtime import io as tio

    x, _ = tube("pipeline", 2)
    x = x.copy()
    vis = np.ones(x.shape[1::-1])
    for p, f, dx in ((3, 2, 0.10), (11, 4, -0.12), (40, 0, 0.08)):
        vis[p, f] = 0.0
        x[f, p] += dx
    tio.save_observations(str(path), x, visibility=vis)


def bal_file(path):
    """``cli_bal``'s BAL file: the masked BA problem of ``problem``."""
    from mvrecon_tpu_torch.runtime import io as tio

    x, X0, K, R, t0, vis, _ = problem("hybrid", 2)
    tio.save_bal(str(path), x.transpose(1, 0, 2), vis, X0, R, t0, K[:, 0, 0])


class kr_budget:
    """Lower the Khatri–Rao budget of ``models.perspective`` to
    ``KR_CHUNK`` points at the case's F while the block runs, and count
    the chunked Gram's calls of the sharded dual step."""

    def __init__(self, nf: int):
        self.nf, self.calls = nf, 0

    def __enter__(self):
        from mvrecon_tpu_torch.models import perspective as tp
        from mvrecon_tpu_torch.parallel import sharded_calibration as tsc

        self.saved = tp._KR_CHUNK_BYTES, tsc._kr_gram

        def counted(*args, **kwargs):
            self.calls += 1
            return self.saved[1](*args, **kwargs)

        tp._KR_CHUNK_BYTES = KR_CHUNK * self.nf * 12 * 8
        tsc._kr_gram = counted
        return self

    def __exit__(self, *exc):
        from mvrecon_tpu_torch.models import perspective as tp
        from mvrecon_tpu_torch.parallel import sharded_calibration as tsc

        tp._KR_CHUNK_BYTES, tsc._kr_gram = self.saved


def _fields(res, keys) -> dict:
    return {k: np.asarray(getattr(res, k)) for k in keys}


CALIB_KEYS = ("X", "R", "t", "K", "depth_error", "depth_iters", "status")
PIPELINE_KEYS = ("X", "K", "R", "t", "error", "n_iter", "calib_X", "status")
COV_KEYS = ("point_cov", "camera_cov", "sigma2", "n_obs", "error")


def run_port_more(case: str, world: int, mesh=None) -> dict:
    """A calibration, pipeline or covariance case through the port,
    sharded over ``mesh`` or unsharded when ``mesh`` is None."""
    from mvrecon_tpu_torch.models.covariance import ba_covariance
    from mvrecon_tpu_torch.models.perspective import perspective_self_calibration
    from mvrecon_tpu_torch.models.pipelines import (
        euclidean_reconstruction,
        euclidean_reconstruction_large,
    )
    from mvrecon_tpu_torch.parallel import (
        sharded_ba_covariance,
        sharded_euclidean_reconstruction,
    )
    from mvrecon_tpu_torch.parallel.sharded_calibration import (
        sharded_perspective_self_calibration,
    )

    core, data, _, fields = GROUPS[world][case]
    if core == "covariance":
        x, X0, K, R, t0, vis, truth = problem(case, world)
        kw = dict(visibility=vis, axis=AXIS, config=LMConfig(**fields), distortion=truth,
                  device="cpu")
        if mesh is None:
            return _fields(ba_covariance(x, X0, K, R, t0, **kw), COV_KEYS)
        return _fields(sharded_ba_covariance(mesh, x, X0, K, R, t0, **kw), COV_KEYS)
    x, vis = tube(case, world)
    if core == "calib":
        if mesh is None:
            return _fields(perspective_self_calibration(x, **fields, device="cpu"), CALIB_KEYS)
        with kr_budget(x.shape[0]) if data == "kr" else contextlib.nullcontext() as budget:
            out = _fields(sharded_perspective_self_calibration(mesh, x, **fields, device="cpu"),
                          CALIB_KEYS)
        out["kr_gram_calls"] = np.asarray(getattr(budget, "calls", 0))
        return out
    if core == "large":
        res = euclidean_reconstruction_large(x, config=LMConfig(**fields), chunk_size=128,
                                             mesh=mesh, device="cpu")
        return {**_fields(res, PIPELINE_KEYS),
                "retries": np.asarray(res.ba_log["n_solver_retries"])}
    cfg = LMConfig(scale_factor=2.0, delta_tol=1e-8, **fields)
    if mesh is None:
        res = euclidean_reconstruction(x, config=cfg, visibility=vis, device="cpu")
    else:
        res = sharded_euclidean_reconstruction(mesh, x, config=cfg, visibility=vis, device="cpu")
    return _fields(res, PIPELINE_KEYS)


def _jax_mesh(world: int, kind: str = "points"):
    import jax

    from mvrecon_tpu.parallel.mesh import hybrid_scene_point_mesh, make_mesh

    devices = jax.devices()[:world]
    return (hybrid_scene_point_mesh(1, devices=devices) if kind == "hybrid"
            else make_mesh({"points": world}, devices=devices))


_JAX_MORE: dict = {}


def run_jax_more(case: str, world: int) -> dict:
    """A calibration, pipeline or covariance case through the JAX
    package's sharded function on a mesh of ``world`` devices (computed
    once a case)."""
    if case in _JAX_MORE:
        return _JAX_MORE[case]
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.models import perspective as jp
    from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large
    from mvrecon_tpu.parallel.pipelines import sharded_euclidean_reconstruction
    from mvrecon_tpu.parallel.sharded_calibration import sharded_perspective_self_calibration
    from mvrecon_tpu.parallel.sharded_covariance import sharded_ba_covariance

    core, data, mesh_kind, fields = GROUPS[world][case]
    mesh = _jax_mesh(world, mesh_kind)
    if core == "covariance":
        x, X0, K, R, t0, vis, truth = problem(case, world)
        res = sharded_ba_covariance(
            mesh, *(jnp.asarray(a) for a in (x, X0, K, R, t0)), f0=1.0,
            visibility=None if vis is None else jnp.asarray(vis), axis=AXIS,
            config=JLMConfig(**fields), distortion=None if truth is None else jnp.asarray(truth))
        out = _fields(res, COV_KEYS)
    else:
        x, vis = tube(case, world)
        if core == "calib":
            saved = jp._KR_CHUNK_BYTES
            if data == "kr":
                jp._KR_CHUNK_BYTES = KR_CHUNK * x.shape[0] * 12 * 8
            try:
                out = _fields(sharded_perspective_self_calibration(mesh, jnp.asarray(x), **fields),
                              CALIB_KEYS)
            finally:
                jp._KR_CHUNK_BYTES = saved
        elif core == "large":
            res = euclidean_reconstruction_large(jnp.asarray(x), config=JLMConfig(**fields),
                                                 chunk_size=128, mesh=mesh)
            out = {**_fields(res, PIPELINE_KEYS),
                   "retries": np.asarray(res.ba_log["n_solver_retries"])}
        else:
            res = sharded_euclidean_reconstruction(
                mesh, jnp.asarray(x), config=JLMConfig(scale_factor=2.0, delta_tol=1e-8, **fields),
                visibility=None if vis is None else jnp.asarray(vis))
            out = _fields(res, PIPELINE_KEYS)
    _JAX_MORE[case] = out
    return out


def sparse_list(case: str, world: int):
    """A sparse case's global numpy inputs: the observation list of the
    visible entries of ``problem``'s x, sorted by point (pi, ci, xy
    (N, 2)), X0, K, R, t0, and the case's LMConfig fields and keywords."""
    fields = dict(GROUPS[world][case][3])
    kw = dict(SPARSE_KW, **fields.pop("kw", {}))
    x, X0, K, R, t0, vis, _ = problem(case, world)
    pi, ci = np.nonzero(np.ones(x.shape[:2]) if vis is None else vis > 0)
    return (pi, ci, x[pi, ci], X0, K, R, t0), fields, kw


def _sparse_arrays(res) -> dict:
    out = result_arrays(res)
    out.update(retries=np.asarray(res.log["n_solver_retries"]),
               cg_iters=np.asarray(res.log["cg_iters_total"]))
    if "reprojection_error" in res.log:
        out["curve"] = np.asarray(res.log["reprojection_error"])
    return out


AFFINE_KEYS = ("S", "R", "ok")


def run_port_new(case: str, world: int, mesh=None) -> dict:
    """A sparse, affine-calibration or affine-pipeline case through the
    port, sharded over ``mesh`` or unsharded when ``mesh`` is None (the
    unsharded calibration with ``canonical_signs=True``)."""
    from mvrecon_tpu_torch.models import bundle_adjustment_sparse as tbs
    from mvrecon_tpu_torch.models.affine import affine_self_calibration
    from mvrecon_tpu_torch.models.pipelines import affine_reconstruction
    from mvrecon_tpu_torch.parallel import (
        sharded_affine_reconstruction,
        sharded_affine_self_calibration,
    )
    from mvrecon_tpu_torch.parallel.sharded_ba_sparse import sharded_bundle_adjust_sparse

    core, _, _, fields = GROUPS[world][case]
    if core == "sparse":
        (pi, ci, xy, X0, K, R, t0), fields, kw = sparse_list(case, world)
        kw.update(axis=AXIS, config=LMConfig(**fields), device="cpu")
        if mesh is None:
            res = tbs.bundle_adjust_sparse(tbs.make_sparse_obs(pi, ci, xy, device="cpu"), X0, K,
                                           R, t0, **kw)
        else:
            res = sharded_bundle_adjust_sparse(mesh, pi, ci, xy, X0, K, R, t0, **kw)
        return _sparse_arrays(res)
    x, _ = tube(case, world)
    f = np.ones(x.shape[0])
    if core == "affine":
        model = fields["model"]
        fm = f if model == "paraperspective" else None
        if mesh is None:
            S, R = affine_self_calibration(x, model=model, f=fm, canonical_signs=True,
                                           device="cpu")
            return {"S": S.numpy(), "R": R.numpy(), "ok": np.asarray(True)}
        S, R, ok = sharded_affine_self_calibration(mesh, x, model=model, f=fm, device="cpu")
        return {"S": S.numpy(), "R": R.numpy(), "ok": np.asarray(bool(ok))}
    cfg = LMConfig(scale_factor=2.0, delta_tol=1e-8, **fields)
    if mesh is None:
        return _fields(affine_reconstruction(x, f, config=cfg, device="cpu"), PIPELINE_KEYS)
    return _fields(sharded_affine_reconstruction(mesh, x, f, config=cfg, device="cpu"),
                   PIPELINE_KEYS)


_JAX_NEW: dict = {}


def run_jax_new(case: str, world: int) -> dict:
    """A sparse, affine-calibration or affine-pipeline case through the
    JAX package's sharded function on a points mesh of ``world`` devices
    (computed once a case)."""
    if case in _JAX_NEW:
        return _JAX_NEW[case]
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.parallel.pipelines import sharded_affine_reconstruction
    from mvrecon_tpu.parallel.sharded_affine import sharded_affine_self_calibration
    from mvrecon_tpu.parallel.sharded_ba_sparse import sharded_bundle_adjust_sparse

    core, _, _, fields = GROUPS[world][case]
    mesh = _jax_mesh(world)
    if core == "sparse":
        (pi, ci, xy, *state), fields, kw = sparse_list(case, world)
        res = sharded_bundle_adjust_sparse(mesh, pi, ci, xy, *map(jnp.asarray, state), f0=1.0,
                                           axis=AXIS, config=JLMConfig(**fields), **kw)
        out = _sparse_arrays(res)
    else:
        x, _ = tube(case, world)
        f = jnp.ones(x.shape[0])
        if core == "affine":
            model = fields["model"]
            S, R, ok = sharded_affine_self_calibration(
                mesh, jnp.asarray(x), model=model, f=f if model == "paraperspective" else None)
            out = {"S": np.asarray(S), "R": np.asarray(R), "ok": np.asarray(ok)}
        else:
            res = sharded_affine_reconstruction(
                mesh, jnp.asarray(x), f,
                config=JLMConfig(scale_factor=2.0, delta_tol=1e-8, **fields))
            out = _fields(res, PIPELINE_KEYS)
    _JAX_NEW[case] = out
    return out


def run_cli(case: str, world: int, outdir: str) -> dict:
    """A command of ``cli.main`` with ``--shard-points`` ``world`` on the
    CPU: its standard output (empty but on rank 0); the size of the
    largest array that the command moved to its device itself (through
    ``config.as_tensor``, which the commands import when they run); and,
    for the synthetic scenes, the observations each rank drew, the largest
    buffer that ``broadcast_array`` sent and the x it returned."""
    import torch.distributed as dist

    import mvrecon_tpu_torch.config as tconfig
    from mvrecon_tpu_torch.cli import main
    from mvrecon_tpu_torch.geometry import scenes as tscenes
    from mvrecon_tpu_torch.runtime import distributed as tdist

    argv = [a.replace("{dir}", outdir) for a in GROUPS[world][case][3]["argv"]]
    buf = io.StringIO()
    rec = {"largest_moved": 0, "drawn": 0, "largest_broadcast": 0}
    saved = tconfig.as_tensor, tscenes.make_synthetic_scene, tdist.broadcast_array
    xs = []

    def recorded(a, device, dtype):
        rec["largest_moved"] = max(rec["largest_moved"], int(np.prod(np.shape(a))))
        return saved[0](a, device, dtype)

    def drawn(*args, **kwargs):
        sc = saved[1](*args, **kwargs)
        rec["drawn"] += sc.x.numel()
        return sc

    def broadcast_array(*args, **kwargs):
        broadcast = dist.broadcast

        def sized(tensor, *a, **k):
            rec["largest_broadcast"] = max(rec["largest_broadcast"], tensor.numel())
            return broadcast(tensor, *a, **k)

        dist.broadcast = sized
        try:
            xs.append(saved[2](*args, **kwargs))
        finally:
            dist.broadcast = broadcast
        return xs[-1]

    tconfig.as_tensor, tscenes.make_synthetic_scene, tdist.broadcast_array = (
        recorded, drawn, broadcast_array)
    try:
        with contextlib.redirect_stdout(buf):
            assert main(argv + ["--shard-points", str(world), "--device", "cpu"]) == 0
    finally:
        tconfig.as_tensor, tscenes.make_synthetic_scene, tdist.broadcast_array = saved
    out = {"stdout": np.asarray(buf.getvalue()), **{k: np.asarray(v) for k, v in rec.items()}}
    if xs:
        out["x"] = xs[0].numpy()
    return out


# ------------------------------------------------------------ the ranks


def _launch(world: int, outdir: pathlib.Path) -> list[dict]:
    """Start ``world`` ranks of this file, wait at most ``RANK_TIMEOUT_S``
    (then kill them and fail), retry a taken port at most 3 times; the
    ranks' npz results."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    outs = []
    for _ in range(3):
        port = free_port()
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
    """Every case's results on every rank: {world: [rank 0's, ...]}, and
    the 2-rank group's directory, which holds the commands' input files
    and what rank 0 wrote."""
    out = {}
    for world in GROUPS:
        outdir = tmp_path_factory.mktemp(f"ranks{world}")
        if world == 2:
            tracks_file(outdir / "tracks.npz")
            bal_file(outdir / "problem.bal")
            out["dir"] = outdir
        out[world] = _launch(world, outdir)
    return out


def _case(outputs: dict, case: str) -> dict:
    return {k.split(".", 1)[1]: v for k, v in outputs.items() if k.startswith(case + ".")}


def _cases(*cores) -> list[tuple[int, str]]:
    return [(world, c) for world, cases in GROUPS.items() for c, v in cases.items()
            if v[0] in cores]


ALL = _cases(*BA_CORES)
CALIBS, PIPELINES, COVS = _cases("calib"), _cases("pipeline"), _cases("covariance")
ARRAYS = _cases(*BA_CORES, "calib", "pipeline", "large", "covariance", *NEW_CORES, "2d")
SPARSES, AFFINES = _cases("sparse"), _cases("affine")
CLIS = [c for _, c in _cases("cli")]


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


@pytest.mark.parametrize("world,case", ARRAYS, ids=[c for _, c in ARRAYS])
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


@pytest.mark.parametrize("world", [2, 3])
def test_only_all_reduce_and_broadcast(ranks, world):
    """No collective other than ``all_reduce`` (sum) and ``broadcast`` was
    called while a case of the 1D sharded functions ran (each case is
    checked on its own; the 2D cases in ``test_2d_collectives``);
    all_reduce was."""
    for out in ranks[world]:
        for case, spec in GROUPS[world].items():
            if spec[0] != "2d":
                assert set(out[f"{case}.collectives"]) <= {"all_reduce(sum)"}, case
        assert int(out["meta.all_reduce_calls"]) > 0


def _rotation(got: dict, want: dict) -> np.ndarray:
    """The rotation q taking got's frame to want's, from camera 0."""
    q = want["R"][0] @ got["R"][0].T
    np.testing.assert_allclose(q @ q.T, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(np.linalg.det(q), 1.0, atol=1e-9)
    return q


def _assert_frames_close(got: dict, want: dict, case: str, atol: dict):
    """R, t and the point sets (``atol``'s other keys) equal up to one
    global rotation."""
    q = _rotation(got, want)
    np.testing.assert_allclose(np.einsum("ij,fjk->fik", q, got["R"]), want["R"], atol=atol["R"],
                               err_msg=f"{case} R")
    for key in set(atol) - {"R"}:
        np.testing.assert_allclose(got[key] @ q.T, want[key], atol=atol[key],
                                   err_msg=f"{case} {key}")


def _assert_calibration_close(got: dict, want: dict, case: str):
    """JAX's bounds (``tests/test_parallel.py``): the same status and depth
    iterations, depth error rtol 1e-8, K, R, t, X atol 1e-6."""
    assert int(got["status"]) == int(want["status"]) == 0, case
    assert int(got["depth_iters"]) == int(want["depth_iters"]), case
    np.testing.assert_allclose(got["depth_error"], want["depth_error"], rtol=1e-8, err_msg=case)
    np.testing.assert_allclose(got["K"], want["K"], atol=1e-6, err_msg=f"{case} K")
    _assert_frames_close(got, want, case, {"R": 1e-6, "t": 1e-6, "X": 1e-6})


@pytest.mark.parametrize("world,case", CALIBS, ids=[c for _, c in CALIBS])
def test_calibration_matches_jax(ranks, world, case):
    _assert_calibration_close(_case(ranks[world][0], case), run_jax_more(case, world), case)


@pytest.mark.parametrize("world,case", CALIBS, ids=[c for _, c in CALIBS])
def test_calibration_matches_unsharded(ranks, world, case):
    _assert_calibration_close(_case(ranks[world][0], case), run_port_more(case, world), case)


@pytest.mark.parametrize("world,case", CALIBS, ids=[c for _, c in CALIBS])
def test_calibration_takes_the_khatri_rao_branch_of_its_block(ranks, world, case):
    """The dual step builds the Khatri–Rao factor in chunks when the rank's
    own point count is above the budget ("kr": 256 points a rank, 128
    a chunk), and whole otherwise."""
    for out in ranks[world]:
        calls = int(out[f"{case}.kr_gram_calls"])
        if case == "calib_dual_kr":
            assert calls == int(out[f"{case}.depth_iters"]) > 0
        else:
            assert calls == 0


def _assert_pipeline_close(got: dict, want: dict, case: str, e_rtol: float = 1e-7):
    """JAX's bounds: error rtol 1e-7, X atol 1e-6, R atol 1e-7; the same
    status and BA iterations; the calibration's X and t to 1e-6."""
    assert int(got["status"]) == int(want["status"]) == 0, case
    assert int(got["n_iter"]) == int(want["n_iter"]), case
    np.testing.assert_allclose(got["error"], want["error"], rtol=e_rtol, err_msg=case)
    _assert_frames_close(got, want, case, {"R": 1e-7, "t": 1e-6, "X": 1e-6, "calib_X": 1e-6})


@pytest.mark.parametrize("world,case", PIPELINES, ids=[c for _, c in PIPELINES])
def test_pipeline_matches_jax(ranks, world, case):
    _assert_pipeline_close(_case(ranks[world][0], case), run_jax_more(case, world), case)


@pytest.mark.parametrize("world,case", PIPELINES, ids=[c for _, c in PIPELINES])
def test_pipeline_matches_unsharded(ranks, world, case):
    _assert_pipeline_close(_case(ranks[world][0], case), run_port_more(case, world), case)


def test_large_pipeline_with_a_mesh_matches_jax(ranks):
    """``euclidean_reconstruction_large(mesh=)``: the sharded calibration,
    then the unsharded chunked BA on every rank, against JAX's with
    ``mesh=make_mesh({"points": 2})``: the same status, iterations and
    retries, E to 1e-6 (``tests/test_torch_pipeline.py``'s bound), and
    the fused build, not K1's, in the BA."""
    got, want = _case(ranks[2][0], "large"), run_jax_more("large", 2)
    assert int(got["status"]) == int(want["status"]) == 0
    assert int(got["n_iter"]) == int(want["n_iter"])
    assert int(got["retries"]) == int(want["retries"])
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-6)
    assert int(got["fused_builds"]) > 0 and int(got["k1_calls"]) == 0


def _assert_covariance_close(got: dict, want: dict, case: str):
    """JAX's bounds (``tests/test_covariance.py``): blocks rtol 2e-6,
    sigma2 rtol 1e-10, the same n_obs."""
    assert got["point_cov"].shape == want["point_cov"].shape
    for key in ("point_cov", "camera_cov"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-6, atol=1e-15,
                                   err_msg=f"{case} {key}")
    np.testing.assert_allclose(got["sigma2"], want["sigma2"], rtol=1e-10, err_msg=case)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-10, err_msg=case)
    assert int(got["n_obs"]) == int(want["n_obs"]), case


@pytest.mark.parametrize("world,case", COVS, ids=[c for _, c in COVS])
def test_covariance_matches_jax(ranks, world, case):
    _assert_covariance_close(_case(ranks[world][0], case), run_jax_more(case, world), case)


@pytest.mark.parametrize("world,case", COVS, ids=[c for _, c in COVS])
def test_covariance_matches_unsharded(ranks, world, case):
    _assert_covariance_close(_case(ranks[world][0], case), run_port_more(case, world), case)


def _assert_sparse_close(got: dict, want: dict, world: int, case: str):
    """JAX's bounds (``tests/test_ba_sparse.py``): E rtol 1e-8, X atol
    1e-7, the distortion atol 1e-10; in recompute mode E rtol 1e-10 and X
    atol 1e-8; the same iterations and retries; R and t as X; the E curve
    as E."""
    remat = GROUPS[world][case][3].get("kw", {}).get("factor_mode") == "recompute"
    e_rtol, x_atol = (1e-10, 1e-8) if remat else (1e-8, 1e-7)
    assert got["X"].shape == want["X"].shape
    np.testing.assert_allclose(got["error"], want["error"], rtol=e_rtol, err_msg=case)
    for key in ("X", "R", "t"):
        np.testing.assert_allclose(got[key], want[key], atol=x_atol, err_msg=f"{case} {key}")
    assert got.keys() & {"distortion", "curve"} == want.keys() & {"distortion", "curve"}
    if "distortion" in want:
        np.testing.assert_allclose(got["distortion"], want["distortion"], atol=1e-10,
                                   err_msg=f"{case} distortion")
    if "curve" in want:
        np.testing.assert_allclose(got["curve"], want["curve"], rtol=e_rtol, err_msg=case)
    assert (int(got["n_iter"]), int(got["retries"])) == (int(want["n_iter"]),
                                                         int(want["retries"])), case


@pytest.mark.parametrize("world,case", SPARSES, ids=[c for _, c in SPARSES])
def test_sparse_matches_jax(ranks, world, case):
    _assert_sparse_close(_case(ranks[world][0], case), run_jax_new(case, world), world, case)


@pytest.mark.parametrize("world,case", SPARSES, ids=[c for _, c in SPARSES])
def test_sparse_matches_unsharded(ranks, world, case):
    _assert_sparse_close(_case(ranks[world][0], case), run_port_new(case, world), world, case)


def _assert_affine_close(got: dict, want: dict, case: str):
    """JAX's bounds (``tests/test_parallel.py``): ok, S and R atol 1e-6."""
    assert bool(got["ok"]) and bool(want["ok"]), case
    for key in ("S", "R"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=f"{case} {key}")


@pytest.mark.parametrize("world,case", AFFINES, ids=[c for _, c in AFFINES])
def test_affine_calibration_matches_jax(ranks, world, case):
    _assert_affine_close(_case(ranks[world][0], case), run_jax_new(case, world), case)


@pytest.mark.parametrize("world,case", AFFINES, ids=[c for _, c in AFFINES])
def test_affine_calibration_matches_unsharded(ranks, world, case):
    """Against ``affine_self_calibration(canonical_signs=True)``: the same
    sign convention, so no rotation of the frame."""
    _assert_affine_close(_case(ranks[world][0], case), run_port_new(case, world), case)


def test_affine_pipeline_matches_jax(ranks):
    _assert_pipeline_close(_case(ranks[2][0], "affine_pipeline"),
                           run_jax_new("affine_pipeline", 2), "affine_pipeline")


def test_affine_pipeline_matches_unsharded(ranks):
    """Against ``affine_reconstruction``, whose calibration pins the same
    signs; the same status 0, iterations, E rtol 1e-7."""
    _assert_pipeline_close(_case(ranks[2][0], "affine_pipeline"),
                           run_port_new("affine_pipeline", 2), "affine_pipeline")


TWO_DS = _cases("2d")


@pytest.fixture(scope="module")
def jax_2d():
    """JAX's ``sharded_bundle_adjust_2d`` of every 2D case, once, on a mesh
    of the case's shape over the virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.parallel.mesh import make_mesh
    from mvrecon_tpu.parallel.sharded_ba_2d import sharded_bundle_adjust_2d

    out = {}
    for world, case in TWO_DS:
        (x, X0, K, R, t0, vis, _), fields, kw = two_d_inputs(case, world)
        axes = mesh_axes(GROUPS[world][case][2])
        mesh = make_mesh(axes, devices=jax.devices()[:axes["points"] * axes["cameras"]])
        out[case] = result_arrays(sharded_bundle_adjust_2d(
            mesh, *(jnp.asarray(a) for a in (x, X0, K, R, t0)), f0=1.0,
            visibility=None if vis is None else jnp.asarray(vis), axis=AXIS,
            config=JLMConfig(**fields), **kw))
    return out


def _assert_2d_close(got: dict, want: dict, case: str, bounds: dict):
    """The same iterations; E within ``bounds["E"]``; then either the
    aligned RMSE of X and the distortion (a refit case: JAX's bounds in
    ``tests/test_distortion.py``) or X, K, R and t, each to its bound."""
    from mvrecon_tpu_torch.ops.procrustes import aligned_rmse

    assert int(got["n_iter"]) == int(want["n_iter"]), case
    np.testing.assert_allclose(got["error"], want["error"], rtol=bounds["E"], err_msg=case)
    if "distortion" in want:
        assert float(aligned_rmse(torch.tensor(got["X"]), torch.tensor(want["X"]))) < 1e-5
        np.testing.assert_allclose(got["distortion"], want["distortion"], atol=5e-3,
                                   err_msg=f"{case} distortion")
        return
    for key in ("X", "K", "R", "t"):
        if key in bounds:
            np.testing.assert_allclose(got[key], want[key], atol=bounds[key],
                                       err_msg=f"{case} {key}")


@pytest.mark.parametrize("world,case", TWO_DS, ids=[c for _, c in TWO_DS])
def test_2d_matches_jax(ranks, jax_2d, world, case):
    """Against JAX's ``sharded_bundle_adjust_2d`` on a mesh of the same
    shape, float64, cg_tol=1e-12: E rtol 1e-8, X atol 1e-6, K, R, t atol
    1e-7; a refit case E rtol 1e-6, aligned RMSE < 1e-5, the distortion
    atol 5e-3."""
    bounds = (dict(E=1e-6) if "distortion" in jax_2d[case]
              else dict(E=1e-8, X=1e-6, K=1e-7, R=1e-7, t=1e-7))
    _assert_2d_close(_case(ranks[world][0], case), jax_2d[case], case, bounds)


@pytest.mark.parametrize("world,case", TWO_DS, ids=[c for _, c in TWO_DS])
def test_2d_matches_1d(ranks, world, case):
    """Against the port's 1D ``sharded_bundle_adjust`` (Cholesky) on a
    points mesh of the same ranks, at JAX's 2D-against-1D bounds
    (``tests/test_parallel.py``: E rtol 1e-7, X atol 1e-5, K and R atol
    1e-6; the refit case ``tests/test_distortion.py``'s)."""
    out = _case(ranks[world][0], case)
    ref = {k[3:]: v for k, v in out.items() if k.startswith("1d_")}
    bounds = dict(E=1e-6) if "distortion" in ref else dict(E=1e-7, X=1e-5, K=1e-6, R=1e-6)
    _assert_2d_close(out, ref, case, bounds)


@pytest.mark.parametrize("world,case", TWO_DS, ids=[c for _, c in TWO_DS])
def test_2d_collectives(ranks, world, case):
    """A 2D case calls ``all_reduce`` with sum and with max (the pmax) on
    every rank, ``batch_isend_irecv`` in ring mode alone (the ring is
    carried by point-to-point sends, never by a gather), and nothing
    else."""
    ring = GROUPS[world][case][3]["kw"]["matvec_mode"] == "ring"
    want = {"all_reduce(sum)", "all_reduce(max)"} | ({"batch_isend_irecv"} if ring else set())
    for out in ranks[world]:
        assert set(out[f"{case}.collectives"]) == want, case


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_axis_collectives_round_trip(ranks, world):
    """On a ``cameras`` mesh of every rank: ``all_gather_axis`` stacks each
    rank's block in coordinate order, ``ppermute_axis`` by +1 brings the
    previous rank's block, and by -1 after +1 gives the block back."""
    for out in ranks[world]:
        assert bool(out["meta.axis_round_trip"])


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_shard_scenes_gives_each_rank_its_block(ranks, world):
    """``shard_scenes`` over a ``scenes`` mesh of every rank: rank r holds
    the r-th contiguous block of the batch."""
    scenes = np.arange(world * 2 * 3, dtype=np.float64).reshape(world * 2, 3)
    for r, out in enumerate(ranks[world]):
        np.testing.assert_array_equal(out["meta.scene_block"], scenes[2 * r:2 * r + 2])


def _record(out: dict, case: str) -> dict:
    lines = str(out[f"{case}.stdout"]).strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("case", CLIS)
def test_rank_0_alone_prints(ranks, case):
    """Under ``--shard-points`` rank 0 prints the one record, with
    ``shard_points``; the other rank prints nothing."""
    assert _record(ranks[2][0], case)["shard_points"] == 2
    assert str(ranks[2][1][f"{case}.stdout"]) == ""


def _synthetic_x(argv: list) -> np.ndarray:
    """The x that ``euclidean`` or ``affine`` draws unsharded on the CPU
    with ``argv``'s views and default seed, points, noise and f."""
    from mvrecon_tpu_torch.cli import build_parser

    args = build_parser().parse_args(argv + ["--device", "cpu"])
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    return make_synthetic_scene(gen, n_images=args.n_images,
                                n_slices=max(1, args.n_points // 20), n_angles=20, f=args.f,
                                f0=args.f0, noise=args.noise, dtype=torch.float64).x.numpy()


@pytest.mark.parametrize("case", ["cli_reconstruct", "cli_bal", "cli_bal_chunked",
                                  "cli_bal_sparse", "cli_euclidean", "cli_affine"])
def test_sharded_commands_leave_the_observations_on_the_host(ranks, case):
    """Under ``--shard-points`` no rank moves the whole (P, F) observations
    or visibility to its device: the command hands host arrays to the
    sharded entry points, which copy only the rank's block. ``bal`` moves
    its cameras, which shows that the recording sees the command's moves.
    ``euclidean`` and ``affine`` draw their scene on rank 0 alone; rank 1
    draws nothing and receives at most half of it at a time, and every
    rank hands the unsharded command's x to the pipeline."""
    rec = _record(ranks[2][0], case)
    npts, nf = ((rec["n_points"], rec["n_views"]) if "points" not in rec
                else (rec["points"], rec["cams"]))
    if case in ("cli_euclidean", "cli_affine"):
        whole = npts * nf * 2
        want = _synthetic_x(CASES[case][3]["argv"])
        for r, rank in enumerate(ranks[2]):
            assert int(rank[f"{case}.drawn"]) == (whole if r == 0 else 0)
            assert 0 < int(rank[f"{case}.largest_broadcast"]) <= whole // 2
            np.testing.assert_array_equal(rank[f"{case}.x"], want)
        return
    for rank in ranks[2]:
        moved = int(rank[f"{case}.largest_moved"])
        assert moved < npts * nf
        assert moved > 0 or case == "cli_reconstruct"


def test_cli_euclidean_matches_unsharded(ranks, capsys):
    """``euclidean --shard-points 2`` against the unsharded command: the
    same status and BA iterations, E to 1e-8, JAX's record keys."""
    from mvrecon_tpu_torch.cli import main

    got = _record(ranks[2][0], "cli_euclidean")
    main(CASES["cli_euclidean"][3]["argv"] + ["--device", "cpu"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["status"], got["ba_iterations"]) == (want["status"], want["ba_iterations"])
    np.testing.assert_allclose(got["reprojection_error"], want["reprojection_error"], rtol=1e-8)
    assert {"command", "status", "ba_iterations", "reprojection_error", "n_points",
            "shard_points"} <= set(got)
    assert set(got["stage_walls_s"]) == {"sharded_perspective_self_calibration",
                                         "sharded_bundle_adjustment"}


def test_cli_reconstruct_matches_jax(ranks):
    """``reconstruct --shard-points 2`` on an npz against JAX's
    ``sharded_euclidean_reconstruction`` on the same arrays (the mask to BA
    only): the same status and iterations, E rtol 1e-7, the X that rank 0
    wrote to ``--output`` atol 1e-6 up to the frame's rotation; the
    ``--log-json`` file holds rank 0's record alone."""
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.parallel.pipelines import sharded_euclidean_reconstruction

    rec = _record(ranks[2][0], "cli_reconstruct")
    d = np.load(ranks["dir"] / "tracks.npz")
    res = sharded_euclidean_reconstruction(
        _jax_mesh(2), jnp.asarray(d["x"]),
        config=JLMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
        visibility=jnp.asarray(d["visibility"]))
    assert rec["status"] == int(res.status) == 0
    assert rec["ba_iterations"] == int(res.n_iter)
    np.testing.assert_allclose(rec["reprojection_error"], float(res.error), rtol=1e-7)
    assert (rec["n_points"], rec["n_views"], rec["n_visible"]) == (200, 8, 200 * 8 - 3)
    out = np.load(ranks["dir"] / "reconstruct.npz")
    _assert_frames_close({k: out[k] for k in ("X", "R", "t")},
                         {k: np.asarray(getattr(res, k)) for k in ("X", "R", "t")},
                         "reconstruct", {"R": 1e-7, "t": 1e-6, "X": 1e-6})
    logged = (ranks["dir"] / "reconstruct.jsonl").read_text().strip().splitlines()
    assert [json.loads(line) for line in logged] == [rec]


@pytest.mark.parametrize("case", ["cli_bal", "cli_bal_chunked"])
def test_cli_bal_matches_jax(ranks, capsys, case):
    """``bal --shard-points 2`` (dense, and chunked with ``--chunk-size``)
    against the JAX package's command with the same flags, which runs
    ``sharded_bundle_adjust(_chunked)`` on a points mesh of 2 devices:
    the same iterations and counts, E rtol 1e-8."""
    from mvrecon_tpu.cli import main as jmain

    got = _record(ranks[2][0], case)
    argv = [a.replace("{dir}", str(ranks["dir"])) for a in CASES[case][3]["argv"]]
    jmain(argv + ["--shard-points", "2"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("cams", "points", "observations", "ba_iterations", "shard_points"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["reprojection_error"], want["reprojection_error"], rtol=1e-8)


def test_cli_affine_matches_unsharded_and_jax(ranks, capsys):
    """``affine --shard-points 2`` against the unsharded command (the same
    status and BA iterations, E to 1e-8) and against JAX's
    ``sharded_affine_reconstruction`` on the x the ranks drew (E rtol
    1e-7); JAX's record keys."""
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.parallel.pipelines import sharded_affine_reconstruction
    from mvrecon_tpu_torch.cli import main

    got = _record(ranks[2][0], "cli_affine")
    argv = CASES["cli_affine"][3]["argv"]
    main(argv + ["--device", "cpu"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["status"] == want["status"] == 0
    assert got["ba_iterations"] == want["ba_iterations"]
    np.testing.assert_allclose(got["reprojection_error"], want["reprojection_error"], rtol=1e-8)
    assert {"command", "status", "ba_iterations", "reprojection_error", "n_points", "model",
            "shard_points"} <= set(got)
    assert set(got["stage_walls_s"]) == {"sharded_affine_self_calibration",
                                         "sharded_bundle_adjustment"}
    x = ranks[2][0]["cli_affine.x"]
    res = sharded_affine_reconstruction(_jax_mesh(2), jnp.asarray(x), jnp.ones(x.shape[0]),
                                        config=JLMConfig(scale_factor=2.0, delta_tol=1e-8,
                                                         max_iter=100))
    assert got["status"] == int(res.status) and got["ba_iterations"] == int(res.n_iter)
    np.testing.assert_allclose(got["reprojection_error"], float(res.error), rtol=1e-7)


def test_cli_bal_sparse_matches_jax(ranks, capsys):
    """``bal --sparse --shard-points 2`` against the JAX package's command
    with the same flags, which runs ``sharded_bundle_adjust_sparse`` on a
    points mesh of 2 devices, and against the port's unsharded command:
    the same counts, E and the distortion's means rtol 1e-6 (the unsharded
    command's bound against JAX's, ``tests/test_torch_sparse_runtime.py``)."""
    from mvrecon_tpu.cli import main as jmain
    from mvrecon_tpu_torch.cli import main

    got = _record(ranks[2][0], "cli_bal_sparse")
    argv = [a.replace("{dir}", str(ranks["dir"])) for a in CASES["cli_bal_sparse"][3]["argv"]]
    jmain(argv + ["--shard-points", "2"])
    want_jax = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(argv + ["--device", "cpu"])
    want_port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for want in (want_jax, want_port):
        for key in ("cams", "points", "observations", "ba_iterations", "cg_iterations"):
            assert got[key] == want[key], key
        for key in ("reprojection_error", "k1_mean", "k2_mean"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    assert got["shard_points"] == want_jax["shard_points"] == 2


def _command(args: list, torchrun: bool = False) -> subprocess.CompletedProcess:
    """``python -m mvrecon_tpu_torch ARGS`` (under torchrun, standalone) in
    a process of its own, with none of torchrun's variables inherited."""
    from mvrecon_tpu_torch.runtime.distributed import TORCHRUN_VARS

    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]
    return subprocess.run([sys.executable] + (launcher if torchrun else [])
                          + ["-m", "mvrecon_tpu_torch"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=RANK_TIMEOUT_S)


def test_shard_points_one_runs_alone():
    """``--shard-points 1`` with no launcher forms a one-rank group."""
    run = _command(["euclidean", "--n-images", "6", "--shard-points", "1", "--device", "cpu",
                    "--float64"])
    assert run.returncode == 0, run.stderr
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert rec["shard_points"] == 1 and rec["status"] == 0


def test_shard_points_two_needs_a_launcher():
    """``--shard-points 2`` with no launcher fails and names torchrun."""
    run = _command(["euclidean", "--shard-points", "2", "--device", "cpu"])
    assert run.returncode != 0 and run.stdout == ""
    assert "torchrun --nproc-per-node 2 -m mvrecon_tpu_torch" in run.stderr


def test_torchrun_runs_a_sharded_command():
    """Under ``torchrun --nproc-per-node 2`` each rank joins from
    torchrun's variables, and one record is printed."""
    run = _command(["euclidean", "--n-images", "6", "--shard-points", "2", "--device", "cpu",
                    "--float64"], torchrun=True)
    assert run.returncode == 0, run.stderr
    recs = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    assert len(recs) == 1 and recs[0]["shard_points"] == 2 and recs[0]["status"] == 0


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
    """An axis name no sharded call binds raises ``ValueError``, in the
    dense and the sparse core, as do lanes under an axis name and the 2D
    BA's solver hook without a bound ``cameras`` axis. Without a launcher
    ``affine`` and ``bal --sparse`` with ``--shard-points 2`` fail and name
    torchrun, as the other sharded commands do."""
    from mvrecon_tpu_torch.__main__ import main
    from mvrecon_tpu_torch.models import bundle_adjustment_sparse as tbs
    from mvrecon_tpu_torch.parallel.sharded_ba_2d import _row_sharded_cg_solver

    x, X0, K, R, t0, _, _ = problem("dense", 2)
    (X, f, u, t, Rn), xs, vs, free = step_inputs(x, X0, R, t0)
    state = tba.BAState(*(torch.from_numpy(a) for a in (X, f, u, t, Rn)))
    targs = (torch.from_numpy(xs), state, torch.from_numpy(vs), torch.from_numpy(free), 1.0)
    with pytest.raises(ValueError, match="not bound"):
        tba.lm_step(*targs, torch.tensor(1e-3, dtype=torch.float64), "points")
    lanes = tba.BAState(*(a[None] for a in state))
    with pytest.raises(ValueError, match="one problem"):
        tba.lm_lanes(targs[0], lanes, *targs[2:], LMConfig(), axis_name="points")
    pi, ci = np.nonzero(vs > 0)
    obs = tbs.make_sparse_obs(pi, ci, xs[pi, ci], device="cpu")
    with pytest.raises(ValueError, match="not bound"):
        tbs.lm_optimize_sparse(obs, state, targs[3], 1.0, LMConfig(), axis_name="points")
    with pytest.raises(ValueError, match="'cameras' is not bound"):
        tba.lm_optimize(*targs, LMConfig(), solver=_row_sharded_cg_solver())
    for argv in (["bal", "unused.bal", "--sparse"], ["affine"]):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            main(argv + ["--shard-points", "2", "--device", "cpu"])


def test_2d_rejects_an_indivisible_f_and_an_unknown_mode(fake_world):
    """F = 12 on a ``cameras`` axis of 8 raises ``ValueError`` naming
    "divisible" (JAX's ``test_2d_mesh_rejects_indivisible_f``), as does a
    ``matvec_mode`` other than "all_gather" and "ring" (where JAX's
    takes the gather), both before any collective."""
    from mvrecon_tpu_torch.parallel.mesh import make_mesh
    from mvrecon_tpu_torch.parallel.sharded_ba_2d import sharded_bundle_adjust_2d

    x, X0, K, R, t0, _, _ = problem("dense", 2)
    with pytest.raises(ValueError, match="divisible"):
        sharded_bundle_adjust_2d(make_mesh({"points": 1, "cameras": 8}), x, X0, K, R, t0,
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown matvec_mode"):
        sharded_bundle_adjust_2d(make_mesh({"points": 2, "cameras": 4}), x, X0, K, R, t0,
                                 matvec_mode="tree", device="cpu")


def test_calibration_rejects_an_indivisible_point_count(fake_world):
    """P must divide by the points-axis size: no mask can neutralize
    padding in the Gram (JAX's ``ValueError``)."""
    from mvrecon_tpu_torch.parallel.mesh import make_mesh
    from mvrecon_tpu_torch.parallel.pipelines import sharded_euclidean_reconstruction
    from mvrecon_tpu_torch.parallel.sharded_calibration import (
        sharded_perspective_self_calibration,
    )

    mesh, x = make_mesh({"points": 4}), np.zeros((4, 201, 2))
    with pytest.raises(ValueError, match="divisible"):
        sharded_perspective_self_calibration(mesh, x, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        sharded_euclidean_reconstruction(mesh, x, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        sharded_perspective_self_calibration(mesh, x[:, :200], method="svd", device="cpu")


def test_affine_rejects_an_indivisible_point_count(fake_world):
    """The sharded affine calibration and pipeline take P divisible by the
    points-axis size (JAX's ``ValueError``, naming "divisible"), raised
    before any collective; an unknown model or a paraperspective call
    without f raise as the unsharded calibration does."""
    from mvrecon_tpu_torch.parallel import (
        sharded_affine_reconstruction,
        sharded_affine_self_calibration,
    )
    from mvrecon_tpu_torch.parallel.mesh import make_mesh

    mesh, x = make_mesh({"points": 4}), np.zeros((4, 201, 2))
    with pytest.raises(ValueError, match="divisible"):
        sharded_affine_self_calibration(mesh, x, model="orthographic", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        sharded_affine_reconstruction(mesh, x, np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="unknown affine model"):
        sharded_affine_self_calibration(mesh, x[:, :200], model="projective", device="cpu")
    with pytest.raises(ValueError, match="requires focal lengths"):
        sharded_affine_self_calibration(mesh, x[:, :200], device="cpu")


def test_shard_scenes_takes_the_rank_s_block(fake_world):
    """Rank 0 of a (scenes 4, points 2) mesh holds the first quarter of the
    batch, on its device; a batch that does not split raises."""
    from mvrecon_tpu_torch.parallel.batched import shard_scenes
    from mvrecon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"scenes": 4, "points": 2})
    x = np.arange(8 * 5 * 2, dtype=np.float32).reshape(8, 5, 2)
    block = shard_scenes(x, mesh)
    assert block.device.type == "cpu"
    np.testing.assert_array_equal(block.numpy(), x[:2])
    with pytest.raises(ValueError, match="does not split"):
        shard_scenes(x[:6], mesh)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_partition_sparse_obs_matches_jax(n_shards):
    """``partition_sparse_obs`` equals JAX's array for array on the masked
    problem's list (201 points), weights given and not."""
    from mvrecon_tpu.parallel.sharded_ba_sparse import partition_sparse_obs as jpartition
    from mvrecon_tpu_torch.parallel.sharded_ba_sparse import partition_sparse_obs

    (pi, ci, xy, X0, *_), _, _ = sparse_list("sparse", 2)
    w = np.random.default_rng(n_shards).uniform(0.5, 1.0, size=pi.shape)
    for weights in (None, w):
        got, pps = partition_sparse_obs(pi, ci, xy, X0.shape[0], n_shards, weights)
        want, jpps = jpartition(pi, ci, xy, X0.shape[0], n_shards, weights)
        assert pps == jpps
        for g, j in zip(got, want):
            assert g.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="sorted by point_idx"):
        partition_sparse_obs(pi[::-1], ci, xy, X0.shape[0], n_shards)


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
    """Record every ``all_reduce`` (by its op) and ``batch_isend_irecv``
    call in ``record["called"]``, and refuse any other collective called
    through ``torch.distributed`` (recorded too). ``isend`` and ``irecv``
    are refused when called; a ``P2POp`` built on them, which
    ``batch_isend_irecv`` runs, gets the real ones."""
    import torch.distributed as dist

    all_reduce, batch, p2p_op = dist.all_reduce, dist.batch_isend_irecv, dist.P2POp
    ops = {dist.ReduceOp.SUM: "sum", dist.ReduceOp.MAX: "max"}

    def counted(tensor, op=dist.ReduceOp.SUM, *args, **kwargs):
        record["called"].append(f"all_reduce({ops.get(op, op)})")
        record["all_reduce"] += 1
        return all_reduce(tensor, op, *args, **kwargs)

    def batch_counted(p2p_ops):
        record["called"].append("batch_isend_irecv")
        return batch(p2p_ops)

    def refused(name):
        def call(*args, **kwargs):
            record["called"].append(name)
            raise RuntimeError(f"collective {name} called")
        return call

    real = {}
    for name in OTHER_COLLECTIVES:
        if hasattr(dist, name) and name != "batch_isend_irecv":
            real[name] = getattr(dist, name)
            setattr(dist, name, refused(name))
    wrapped = {getattr(dist, name): real[name] for name in ("isend", "irecv")}
    dist.all_reduce, dist.batch_isend_irecv = counted, batch_counted
    dist.P2POp = lambda op, *args, **kwargs: p2p_op(wrapped.get(op, op), *args, **kwargs)


def _axis_round_trip(world: int) -> bool:
    """``all_gather_axis`` and ``ppermute_axis`` (+1, then -1) on a
    ``cameras`` mesh of every rank, each rank holding the block [r, r+1]."""
    import torch.distributed as dist

    from mvrecon_tpu_torch.parallel.mesh import bind_axes, make_mesh
    from mvrecon_tpu_torch.runtime.distributed import all_gather_axis, ppermute_axis

    rank = dist.get_rank()
    block = torch.tensor([rank, rank + 1.0], dtype=torch.float64)
    with bind_axes(make_mesh({"cameras": world})):
        gathered = all_gather_axis(block, "cameras")
        shifted = ppermute_axis(block, "cameras")
        back = ppermute_axis(shifted, "cameras", shift=-1)
    prev = (rank - 1) % world
    every = torch.arange(world, dtype=torch.float64)
    return (torch.equal(gathered, torch.stack([every, every + 1.0], dim=1).reshape(-1))
            and torch.equal(shifted, torch.tensor([prev, prev + 1.0], dtype=torch.float64))
            and torch.equal(back, block))


def _rank_main(port: int, rank: int, world: int, outdir: str) -> None:
    from mvrecon_tpu_torch.parallel.batched import shard_scenes
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
    for kind in sorted({v[2] for v in GROUPS[world].values() if v[0] == "2d"}):
        meshes[kind] = make_mesh(mesh_axes(kind))
    record = {"all_reduce": 0, "called": []}
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
    scenes = np.arange(world * 2 * 3, dtype=np.float64).reshape(world * 2, 3)
    scene_block = shard_scenes(scenes, make_mesh({"scenes": world}))
    out = {"meta.scene_block": scene_block.numpy(), "meta.round_trip": np.asarray(
        block.shape == (5, 2)
        and np.array_equal(gather_array(meshes["points"], block, ("points",)).numpy(), arr)
        and np.array_equal(replicate_array(meshes["points"], arr, "cpu").numpy(), arr)),
        "meta.axis_round_trip": np.asarray(_axis_round_trip(world))}
    for case, (core, _, mesh_kind, _) in GROUPS[world].items():
        counts.update(k1=0, fused=0)
        record["called"] = []
        if core == "2d":
            res = run_port_2d(case, world, meshes[mesh_kind], meshes["points"])
        elif core == "cli":
            res = run_cli(case, world, outdir)
        elif core in NEW_CORES:
            res = run_port_new(case, world, meshes[mesh_kind])
        elif core in BA_CORES:
            res = run_port(case, world, meshes[mesh_kind])
        else:
            res = run_port_more(case, world, meshes[mesh_kind])
        res.update(k1_calls=counts["k1"], fused_builds=counts["fused"],
                   collectives=np.array(sorted(set(record["called"])), dtype=str))
        out.update({f"{case}.{k}": v for k, v in res.items()})
    n_pad = 199 if world == 3 else 201
    out["meta.rows_per_rank"] = np.asarray(-(-n_pad // world))
    out["meta.all_reduce_calls"] = np.asarray(record["all_reduce"])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
