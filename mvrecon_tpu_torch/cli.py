"""Command line of the port. Each subcommand prints one JSON record, under
the JAX package's keys (``command``, ``status``, ``ba_iterations``,
``reprojection_error``, ``n_points``) with the port's own beside them
(``device``, ``dtype``, ``wall_s``, ``stage_walls_s``, ``E_vs_noise_floor``).
``reconstruct`` runs a pipeline on tracks read from an npz file, ``bal``
bundle-adjusts a problem read from disk (a BAL file or a COLMAP model),
``bench-ba`` times BA, and the others build synthetic scenes:

    python -m mvrecon_tpu_torch euclidean --n-images 10 --method dual
    python -m mvrecon_tpu_torch euclidean-large --n-points 2000 --n-images 16
    python -m mvrecon_tpu_torch affine --model paraperspective --n-images 12
    python -m mvrecon_tpu_torch batch --scenes 8 --n-images 10 --scene-chunk 4
    python -m mvrecon_tpu_torch reconstruct tracks.npz --covariance --output-ply cloud.ply
    python -m mvrecon_tpu_torch bench-ba --points 100000 --views 1000 --chunked --chunk-size 768
    python -m mvrecon_tpu_torch bal sparse/0 --chunk-size 768 --optimize-distortion 1
    python -m mvrecon_tpu_torch bal problem.bal --sparse --huber 0.02 --triangulate-init

Every subcommand takes ``--log-json FILE`` (append the record),
``--profile DIR`` (a ``torch.profiler`` trace of the run) and ``--viz``
(matplotlib plots of a synthetic scene's result). Under ``--profile``,
``bal --sparse`` (with or without ``--shard-points``) also times the
sparse core's spans (``runtime.profiling.EventTimer``: ``build`` and its
``state``, ``point_side`` and ``camera_side``, ``matvec``, ``host_read``),
which then lie beside the kernels in the trace, and the record carries
``span_ms``, the total milliseconds of each span by name.
``stage_walls_s`` holds the pipeline's outermost stages alone, which add
up to the run; the calibration's inner stages (``projective_depths``,
``kr_eigh``, ``subspace_eigh``) are only ranges of the ``--profile``
trace. Runs on the card unless ``--device`` says otherwise. The JAX package's ``--platform`` and
``--num-cpu-devices`` (XLA switches) have ``--device`` as counterpart.

``--shard-points N`` splits the points of ``euclidean``, ``affine``,
``reconstruct`` (the euclidean pipeline) and ``bal`` (dense, chunked or
``--sparse``) over N ranks, one process each
(``runtime.distributed.join_ranks``): under torchrun,

    torchrun --nproc-per-node N -m mvrecon_tpu_torch euclidean --shard-points N

(``--device cpu`` takes gloo, the cards NCCL), in a process group the
caller already formed (``cli.main`` called in each rank), or with N = 1
alone. Every rank keeps the per-point arrays on the host, copies only its
block of them to its device and computes the global result; the synthetic
scene of ``euclidean`` and ``affine`` is drawn on rank 0's device alone and
reaches the others' hosts through a block-sized buffer
(``runtime.distributed.broadcast_array``). Rank 0 alone prints the record
and writes the files and the covariance, which runs unsharded, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from .config import as_numpy


def _common(p: argparse.ArgumentParser, seed: int = 123) -> None:
    """The flags every subcommand takes (the JAX package's ``_common``)."""
    p.add_argument("--seed", type=int, default=seed)
    p.add_argument("--noise", type=float, default=0.005,
                   help="image noise of the synthetic scenes")
    p.add_argument("--f", type=float, default=1.0, help="focal length of the synthetic scenes")
    p.add_argument("--f0", type=float, default=1.0, help="scale constant of the image points")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--float64", action="store_true", help="run in float64")
    p.add_argument("--viz", action="store_true", help="plot the result (needs matplotlib)")
    p.add_argument("--log-json", default=None, metavar="FILE",
                   help="append the record to this JSON-lines file")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to DIR (Chrome/Perfetto)")


def _scene_args(p: argparse.ArgumentParser, n_points: int, n_images: int, seed: int) -> None:
    p.add_argument("--n-points", type=int, default=n_points,
                   help="points (the curved tube gets n_points // 20 slices of 20)")
    p.add_argument("--n-images", type=int, default=n_images)
    _common(p, seed)


def _lm_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max-iter", type=int, default=100, help="BA iterations")
    p.add_argument("--delta-tol", type=float, default=1e-8)
    p.add_argument("--scale-factor", type=float, default=2.0)


def _shard_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--shard-points", type=int, default=0, metavar="N",
                   help=f"split the points over N ranks, one process each ({what}); under "
                   "torchrun --nproc-per-node N, or N = 1 alone")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvrecon_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("euclidean", help="self-calibration + dense BA on a synthetic scene")
    _scene_args(p, n_points=200, n_images=10, seed=123)
    p.add_argument("--method", choices=["primary", "dual"], default="dual")
    p.add_argument("--tol", type=float, default=1e-2)
    p.add_argument("--eig-method", choices=["eigh", "lowrank", "power"], default="eigh")
    _lm_args(p)
    _shard_arg(p, "the calibration and BA; P must divide by N")

    p = sub.add_parser("affine", help="affine self-calibration + dense BA on a synthetic scene")
    _scene_args(p, n_points=200, n_images=12, seed=123)
    p.add_argument("--model", choices=["orthographic", "symmetric", "paraperspective"],
                   default="paraperspective")
    _lm_args(p)
    _shard_arg(p, "the calibration and BA; P must divide by N")

    p = sub.add_parser("batch", help="scene-batched perspective pipeline on synthetic scenes")
    _scene_args(p, n_points=200, n_images=10, seed=123)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--method", choices=["primary", "dual"], default="dual")
    p.add_argument("--tol", type=float, default=1e-2)
    p.add_argument("--eig-method", choices=["eigh", "lowrank", "power"], default="eigh")
    p.add_argument("--scene-chunk", type=int, default=None,
                   help="scenes per block (default: all in one block)")
    _lm_args(p)

    p = sub.add_parser("euclidean-large",
                       help="self-calibration + chunked BA on a synthetic scene")
    _scene_args(p, n_points=2000, n_images=16, seed=0)
    p.add_argument("--chunk-size", type=int, default=768)
    p.add_argument("--max-iter", type=int, default=8, help="BA iterations")

    p = sub.add_parser("reconstruct", help="reconstruct from tracked features in an .npz file")
    p.add_argument("input", help=".npz with x (F, P, 2) [+ visibility (P, F), f (F,), f0, X_gt]")
    _common(p)
    _lm_args(p)
    p.add_argument("--output", default=None, help="write the result .npz here")
    p.add_argument("--output-ply", default=None, metavar="FILE",
                   help="write the points (and camera centres) as PLY, with the per-point "
                   "sigma as quality under --covariance")
    p.add_argument("--pipeline", choices=["euclidean", "affine"], default="euclidean")
    p.add_argument("--covariance", action="store_true",
                   help="per-point and per-camera covariance blocks at the optimum (dense "
                   "core): a summary in the record, the blocks in --output")
    p.add_argument("--method", choices=["primary", "dual"], default="dual")
    p.add_argument("--tol", type=float, default=1e-2)
    p.add_argument("--model", choices=["orthographic", "symmetric", "paraperspective"],
                   default="paraperspective")
    _shard_arg(p, "the euclidean pipeline only; P must divide by N")

    _bal_args(sub.add_parser("bal", help="bundle-adjust a BAL problem file or a COLMAP model"))

    p = sub.add_parser("bench-ba", help="time bundle adjustment on a synthetic scene")
    _common(p)
    _lm_args(p)
    p.add_argument("--points", type=int, default=2000)
    p.add_argument("--views", type=int, default=50)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--chunked", action="store_true", help="the chunked core")
    p.add_argument("--chunk-size", type=int, default=4096)
    return parser


def _bal_args(p: argparse.ArgumentParser) -> None:
    """The flags of ``bal``, as the JAX package's command line has them."""
    p.add_argument("input", help="BAL text file (Agarwal et al. ECCV 2010 format), or a "
                   "directory holding a COLMAP model, binary or text")
    _common(p)
    _lm_args(p)
    p.add_argument("--output", default=None, help="write the result .npz here")
    p.add_argument("--output-colmap", default=None, metavar="DIR",
                   help="write the refined model as a COLMAP text model")
    p.add_argument("--output-bal", default=None, metavar="FILE",
                   help="write the refined problem in BAL format (radial models only)")
    p.add_argument("--output-colmap-pinhole", default=None, metavar="DIR",
                   help="write an undistorted SIMPLE_PINHOLE COLMAP model: the refined "
                   "geometry with the observations mapped through the inverse of the "
                   "distortion model")
    p.add_argument("--output-ply", default=None, metavar="FILE",
                   help="write the refined points and camera centres as PLY")
    p.add_argument("--huber", type=float, default=None, metavar="DELTA",
                   help="robust IRLS at this scale; the loss from --robust-loss")
    p.add_argument("--robust-loss", choices=["huber", "cauchy", "soft_l1", "arctan"],
                   default="huber")
    p.add_argument("--optimize-distortion", type=int, default=0, metavar="R",
                   help="alternate R refits of the distortion with the geometry LM")
    p.add_argument("--shared-k", action="store_true",
                   help="tie the distortion across the cameras during the refit")
    p.add_argument("--tangential", action="store_true",
                   help="fit the 4-parameter OPENCV model even if the input is radial")
    p.add_argument("--ignore-distortion", action="store_true",
                   help="pinhole model: drop the input's distortion")
    p.add_argument("--covariance", action="store_true",
                   help="per-point and per-camera covariance blocks at the optimum (chunked "
                   "with --chunk-size): a summary in the record, the blocks in --output")
    p.add_argument("--damping", choices=["reference", "nielsen"], default="nielsen")
    p.add_argument("--chunk-size", type=int, default=0, metavar="C",
                   help="the chunked core, C points a chunk (default: the dense core)")
    _shard_arg(p, "the dense, chunked or --sparse core")
    p.add_argument("--sparse", action="store_true",
                   help="the O(n_observations) observation-list core, for BAL files at "
                   "BAL-class sparsity; writes --output-ply and --output-bal")
    p.add_argument("--cg-max-iter", type=int, default=100, metavar="K",
                   help="(--sparse) CG iteration cap of the camera step")
    p.add_argument("--bf16-factors", action="store_true",
                   help="(--sparse) store the per-observation Jacobian factor rows in bfloat16")
    p.add_argument("--recompute-factors", action="store_true",
                   help="(--sparse) store no factor rows: recompute them in every pass")
    p.add_argument("--triangulate-init", action="store_true",
                   help="(--sparse) start from a DLT triangulation of the observations through "
                   "the file's cameras instead of the file's points")


def _shard_count(args) -> int:
    """The ranks the command splits its points over: ``--shard-points``
    for ``euclidean``, ``affine``, ``reconstruct``'s euclidean pipeline
    (its affine one runs unsharded, as in the JAX package) and ``bal``; 0
    for none."""
    n = getattr(args, "shard_points", 0)
    if n <= 0:
        return 0
    if args.command == "reconstruct" and args.pipeline != "euclidean":
        return 0
    return n


def _lead(args) -> bool:
    """Whether this process prints the record and writes the files: rank 0
    of a sharded command, and every unsharded one."""
    return not _shard_count(args) or torch.distributed.get_rank() == 0


def _points_mesh(args):
    """The ``points`` mesh over the command's ranks."""
    from .parallel.mesh import make_mesh

    return make_mesh({"points": args.shard_points})


def _on_host(a, dt) -> torch.Tensor:
    """A copy of ``a`` in ``dt`` on the host. A sharded command keeps its
    per-point arrays there: each rank copies only its block to its device,
    and rank 0 moves the whole problem there only for the covariance and
    the writers."""
    return torch.tensor(np.asarray(a), dtype=dt)


def _cmd_bal(args, out: dict, dev, dt) -> None:
    """``bal``: load the problem, run the dense or the chunked core, and the
    covariance and the writers asked for; one JSON record under the JAX
    package's keys."""
    import functools
    import os

    from .config import LMConfig, as_tensor
    from .models.bundle_adjustment import bundle_adjust, undistort_points
    from .models.bundle_adjustment_chunked import bundle_adjust_chunked
    from .models.covariance import ba_covariance, ba_covariance_chunked
    from .parallel.sharded_ba import sharded_bundle_adjust, sharded_bundle_adjust_chunked
    from .runtime import io

    if args.sparse:
        _cmd_bal_sparse(args, out, dev, dt)
        return
    if args.chunk_size > 0:
        ba_fn = functools.partial(bundle_adjust_chunked, chunk_size=args.chunk_size)
        cov_fn = functools.partial(ba_covariance_chunked, chunk_size=args.chunk_size)
    else:
        ba_fn, cov_fn = bundle_adjust, ba_covariance
    sharded = _shard_count(args)
    if sharded:
        mesh = _points_mesh(args)
        ba_fn = (functools.partial(sharded_bundle_adjust_chunked, mesh, chunk_size=args.chunk_size)
                 if args.chunk_size > 0 else functools.partial(sharded_bundle_adjust, mesh))
        out["shard_points"] = args.shard_points
    if os.path.isdir(args.input):
        d = io.load_colmap(args.input)
        out["format"] = "colmap"
    else:
        d = io.load_bal(args.input)

    def dev_t(a):
        return as_tensor(np.ascontiguousarray(a), dev, dt)

    pts_t = functools.partial(_on_host, dt=dt) if sharded else dev_t
    x = pts_t(d["x"].transpose(1, 0, 2))  # (P, F, 2)
    vis = pts_t(d["visibility"])
    in_model = str(d.get("distortion_model", "auto"))
    if in_model in ("fisheye", "fov", "thin_prism"):
        out["camera_model"] = in_model
        if args.tangential:
            raise SystemExit("--tangential fits the OPENCV (p1, p2) model; the input is a "
                             f"{in_model} camera (a different projection family)")
    elif args.tangential and in_model == "radial":
        in_model = "opencv"  # the radial input is widened to OPENCV below
    cfg = LMConfig(scale_factor=args.scale_factor, delta_tol=args.delta_tol,
                   max_iter=args.max_iter, damping=args.damping,
                   robust=args.robust_loss if args.huber is not None else None,
                   huber_delta=args.huber if args.huber is not None else 0.05,
                   distortion_rounds=args.optimize_distortion,
                   distortion_shared=args.shared_k, distortion_model=in_model)
    dist = None if args.ignore_distortion else dev_t(d["distortion"])
    if args.tangential and not args.ignore_distortion and dist.shape[-1] == 2:
        dist = torch.cat([dist, torch.zeros_like(dist)], dim=-1)
    f0 = float(d["f0"])
    common = dict(f0=f0, visibility=vis, axis="x-up_z-forward", config=cfg, device=dev)
    res = ba_fn(x, pts_t(d["X"]), dev_t(d["K"]), dev_t(d["R"]), dev_t(d["t"]),
                distortion=dist, **common)
    out.update(cams=int(vis.shape[1]), points=int(vis.shape[0]),
               observations=int(d["visibility"].sum()), ba_iterations=int(res.n_iter),
               reprojection_error=float(res.error))
    if not _lead(args):
        return
    X, K, R, t = (as_numpy(a) for a in (res.X, res.K, res.R, res.t))
    cov = pt_sig = None
    if args.covariance:
        cov = cov_fn(x, res.X, res.K, res.R, res.t, distortion=res.distortion, **common)
        pt_sig = np.sqrt(as_numpy(cov.point_cov).trace(axis1=1, axis2=2) / 3.0)
        cam_t_sig = np.sqrt(as_numpy(cov.camera_cov)[:, 3:6, 3:6].trace(axis1=1, axis2=2) / 3.0)
        out.update(sigma=float(np.sqrt(float(cov.sigma2))),
                   point_sigma_median=float(np.median(pt_sig)),
                   point_sigma_max=float(pt_sig.max()),
                   camera_pos_sigma_median=float(np.median(cam_t_sig)))
    dmat = None if res.distortion is None else as_numpy(res.distortion)
    if dmat is not None and dmat.shape[-1] == 1:  # FOV: one angle
        out["omega_mean"] = float(dmat[:, 0].mean())
    elif dmat is not None:
        out["k1_mean"] = float(dmat[:, 0].mean())
        out["k2_mean"] = float(dmat[:, 1].mean())
        if dmat.shape[-1] == 8:
            names = (("k3", "k4", "p1", "p2", "sx1", "sy1") if in_model == "thin_prism"
                     else ("k3", "k4", "k5", "k6", "p1", "p2"))
            for j, name in enumerate(names, start=2):
                out[f"{name}_mean"] = float(dmat[:, j].mean())
        elif dmat.shape[-1] == 4:
            n3, n4 = ("k3", "k4") if in_model == "fisheye" else ("p1", "p2")
            out[f"{n3}_mean"] = float(dmat[:, 2].mean())
            out[f"{n4}_mean"] = float(dmat[:, 3].mean())
    if args.output:
        extra = {} if dmat is None else {"distortion": dmat}
        if cov is not None:
            extra.update(point_cov=as_numpy(cov.point_cov), camera_cov=as_numpy(cov.camera_cov),
                         sigma2=as_numpy(cov.sigma2))
        io.save_observations(args.output, d["x"], X=X, K=K, R=R, t=t,
                             visibility=d["visibility"], **extra)
        out["output"] = args.output
    dist_out = dmat if dmat is not None else (None if args.ignore_distortion
                                              else d["distortion"])
    if args.output_colmap:
        io.save_colmap(args.output_colmap, d["x"], d["visibility"], X, R, t, K[:, 0, 0],
                       principal_point=K[:, :2, 2], distortion=dist_out,
                       distortion_model=in_model if in_model in ("fisheye", "thin_prism")
                       else None)
        out["output_colmap"] = args.output_colmap
    if args.output_bal:
        if dist_out is not None and dist_out.shape[-1] != 2:
            raise SystemExit("--output-bal: BAL carries only (k1, k2); this model has "
                             f"{dist_out.shape[-1]} parameters, use --output-colmap")
        io.save_bal(args.output_bal, d["x"], d["visibility"], X, R, t, K[:, 0, 0],
                    distortion=dist_out)
        out["output_bal"] = args.output_bal
    if args.output_colmap_pinhole:
        x_un = x if dist_out is None else undistort_points(
            as_tensor(x, dev, dt), res.K[:, 0, 0], res.K[:, :2, 2], f0=f0, distortion=dev_t(dist_out),
            distortion_model=in_model)
        io.save_colmap(args.output_colmap_pinhole, as_numpy(x_un).transpose(1, 0, 2),
                       d["visibility"], X, R, t, K[:, 0, 0], principal_point=K[:, :2, 2])
        out["output_colmap_pinhole"] = args.output_colmap_pinhole
    if args.output_ply:
        io.save_ply(args.output_ply, X, cameras=t, quality=pt_sig)
        out["output_ply"] = args.output_ply


def _cmd_bal_sparse(args, out: dict, dev, dt) -> None:
    """``bal --sparse``: the O(n_obs) path. The BAL file loads straight
    into the observation list (no dense arrays), the sparse core optimizes
    it (from the file's points or a DLT triangulation), and PLY and BAL are
    written from the list; the record carries the JAX package's keys. With
    ``--shard-points`` the list stays on the host and each rank runs its
    block of the partition (``sharded_bundle_adjust_sparse``). Under
    ``--profile`` the core's spans are timed and their totals go to
    ``span_ms``."""
    import os

    from .config import LMConfig, as_tensor
    from .models.bundle_adjustment_sparse import SparseObs, bundle_adjust_sparse
    from .ops.triangulation import triangulate_sparse
    from .runtime import io
    from .runtime.profiling import EventTimer

    if os.path.isdir(args.input):
        raise SystemExit("--sparse reads BAL files; COLMAP models load dense "
                         "(drop --sparse or convert with save_bal first)")
    d = io.load_bal_sparse(args.input)
    npts, nf = int(d["n_points"]), int(d["n_cameras"])
    f0 = float(d["f0"])
    cfg = LMConfig(scale_factor=args.scale_factor, delta_tol=args.delta_tol,
                   max_iter=args.max_iter, damping=args.damping,
                   robust=args.robust_loss if args.huber is not None else None,
                   huber_delta=args.huber if args.huber is not None else 0.05,
                   distortion_rounds=args.optimize_distortion,
                   distortion_shared=args.shared_k)

    def dev_t(a):
        return as_tensor(np.ascontiguousarray(a), dev, dt)

    dist = None if args.ignore_distortion else dev_t(d["distortion"])
    K0, R0, t0 = dev_t(d["K"]), dev_t(d["R"]), dev_t(d["t"])
    sharded = _shard_count(args)
    timer = EventTimer(dev) if args.profile else None
    kw = dict(f0=f0, axis="x-up_z-forward", config=cfg, cg_max_iter=args.cg_max_iter,
              distortion=dist, factor_dtype="bfloat16" if args.bf16_factors else None,
              factor_mode="recompute" if args.recompute_factors else "stored", device=dev,
              timer=timer)
    def idx(key):
        return torch.from_numpy(d[key].astype(np.int32)).to(dev)

    if args.triangulate_init:
        # on the whole list, before any partition, as the JAX command does
        X0 = triangulate_sparse(idx("point_idx"), idx("cam_idx"), dev_t(d["xy"]), npts, K0, R0,
                                t0, f0=f0, device=dev)
        out["triangulate_init"] = True
    else:
        X0 = _on_host(d["X"], dt) if sharded else dev_t(d["X"])
    if sharded:
        from .parallel.sharded_ba_sparse import sharded_bundle_adjust_sparse

        # host arrays: each rank partitions them and copies only its block
        res = sharded_bundle_adjust_sparse(_points_mesh(args), d["point_idx"], d["cam_idx"],
                                           _on_host(d["xy"], dt), X0, K0, R0, t0, **kw)
        out["shard_points"] = args.shard_points
    else:
        pi = idx("point_idx")
        obs = SparseObs(pi, idx("cam_idx"), dev_t(d["xy"]).T.contiguous(),
                        torch.ones(pi.shape[0], dtype=dt, device=dev))
        res = bundle_adjust_sparse(obs, X0, K0, R0, t0, **kw)
    if args.bf16_factors:
        out["factor_dtype"] = "bfloat16"
    if args.recompute_factors:
        out["factor_mode"] = "recompute"
    out.update(format="bal", sparse=True, cams=nf, points=npts,
               observations=int(d["point_idx"].shape[0]), ba_iterations=int(res.n_iter),
               cg_iterations=int(res.log["cg_iters_total"]),
               reprojection_error=float(res.error))
    if timer is not None:
        out["span_ms"] = {k: sum(v) for k, v in timer.ms().items()}
    if not _lead(args):
        return
    dmat = None if res.distortion is None else res.distortion.cpu().numpy()
    if dmat is not None:
        out["k1_mean"] = float(dmat[:, 0].mean())
        out["k2_mean"] = float(dmat[:, 1].mean())
    X, R, t = (as_numpy(a) for a in (res.X, res.R, res.t))
    if args.output_ply:
        io.save_ply(args.output_ply, X, cameras=t)
        out["output_ply"] = args.output_ply
    if args.output_bal:
        dist_out = dmat if dmat is not None else (None if args.ignore_distortion
                                                  else d["distortion"])
        io.save_bal_sparse(args.output_bal, d["point_idx"], d["cam_idx"], d["xy"], npts, X, R, t,
                           res.K[:, 0, 0].cpu().numpy(), distortion=dist_out)
        out["output_bal"] = args.output_bal


def _show(x, res) -> None:
    """``--viz``: the scene in 3D, and the observations against their
    reprojections per image (imports matplotlib)."""
    from .geometry.camera import project_points
    from .viz import show_2d_projection_data, show_3d_scene_data

    show_3d_scene_data(res.X, res.R, res.t)
    reproj = project_points(res.X, res.K, res.R, res.t)
    show_2d_projection_data(list(x), list(reproj))


def _cmd_synthetic(args, out: dict, dev, dt) -> None:
    """``euclidean``, ``affine``, ``batch`` and ``euclidean-large`` on the
    curved-tube scene drawn from ``--seed`` with ``--noise``."""
    from .config import LMConfig
    from .geometry.scenes import make_synthetic_scene
    from .models.pipelines import (
        affine_reconstruction,
        euclidean_reconstruction,
        euclidean_reconstruction_large,
    )
    from .parallel.batched import batched_euclidean_reconstruction
    from .runtime.profiling import StageTimer

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    n_slices = max(1, args.n_points // 20)

    def scene():
        return make_synthetic_scene(gen, n_images=args.n_images, n_slices=n_slices, n_angles=20,
                                    f=args.f, f0=args.f0, noise=args.noise, dtype=dt)

    timer = StageTimer()
    start = time.perf_counter()
    sharded = args.command in ("euclidean", "affine") and _shard_count(args)
    if args.command == "batch":
        x = torch.stack([scene().x for _ in range(args.scenes)])
        n_points = x.shape[2]
    elif sharded:
        from .runtime.distributed import broadcast_array

        # the unsharded command's draw, on rank 0's device alone; the other
        # ranks receive its host copy a block at a time, and every rank
        # then copies its own block of the points back
        n_points = n_slices * 20
        x = broadcast_array(scene().x.cpu() if _lead(args) else None,
                            (args.n_images, n_points, 2), dt, device=dev)
    else:
        x = scene().x
        n_points = x.shape[1]
    if args.command in ("euclidean", "affine", "batch"):
        config = LMConfig(scale_factor=args.scale_factor, delta_tol=args.delta_tol,
                          max_iter=args.max_iter)
    if args.command == "euclidean" and sharded:
        from .parallel.pipelines import sharded_euclidean_reconstruction

        if args.eig_method != "eigh" and _lead(args):
            print("warning: --eig-method is ignored with --shard-points (the sharded "
                  "calibration always uses the exact Gram-subspace eigensolve)", file=sys.stderr)
        res = sharded_euclidean_reconstruction(_points_mesh(args), x, f0=args.f0, tol=args.tol,
                                               method=args.method, config=config, device=dev,
                                               timer=timer)
        out.update(method=args.method, shard_points=args.shard_points)
    elif args.command == "euclidean":
        res = euclidean_reconstruction(x, f0=args.f0, tol=args.tol, method=args.method,
                                       config=config, eig_method=args.eig_method, device=dev,
                                       timer=timer)
        out.update(method=args.method, eig_method=args.eig_method)
    elif args.command == "affine":
        f = torch.full((args.n_images,), args.f, dtype=dt, device=dev)
        if sharded:
            from .parallel.pipelines import sharded_affine_reconstruction

            res = sharded_affine_reconstruction(_points_mesh(args), x, f, model=args.model,
                                                f0=args.f0, config=config, device=dev,
                                                timer=timer)
            out["shard_points"] = args.shard_points
        else:
            res = affine_reconstruction(x, f, model=args.model, f0=args.f0, config=config,
                                        device=dev, timer=timer)
        out["model"] = args.model
    elif args.command == "batch":
        res = batched_euclidean_reconstruction(
            x, f0=args.f0, tol=args.tol, method=args.method, config=config,
            eig_method=args.eig_method, scene_chunk=args.scene_chunk, device=dev, timer=timer,
        )
        out.update(scenes=args.scenes, scene_chunk=args.scene_chunk, method=args.method,
                   eig_method=args.eig_method, statuses=res.status.tolist(),
                   ba_n_iters=res.n_iter.tolist(), reprojection_errors=res.error.tolist(),
                   ba_solver_retries=res.ba_log["n_solver_retries"])
    else:
        config = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=args.max_iter,
                          accept_divisor=1.0, init_damping=3e-3, damping="nielsen")
        res = euclidean_reconstruction_large(x, f0=args.f0, config=config,
                                             chunk_size=args.chunk_size, device=dev,
                                             timer=timer)
        out.update(chunk_size=args.chunk_size,
                   ba_solver_retries=res.ba_log["n_solver_retries"])
    if args.command == "batch":
        err = res.error.max().item()  # the worst scene
        status, n_iter = res.status.max().item(), res.n_iter.max().item()
    else:
        err, status, n_iter = float(res.error), int(res.status), int(res.n_iter)
    wall = time.perf_counter() - start
    floor = n_points * args.n_images * 2 * args.noise**2
    out.update(status=status, ba_iterations=n_iter, reprojection_error=err,
               n_points=n_points, n_views=args.n_images, wall_s=wall,
               stage_walls_s=timer.times, E_vs_noise_floor=err / floor if floor > 0 else None)
    if args.viz and args.command in ("euclidean", "affine") and _lead(args):
        _show(x, res)


# The dual depth step's dense eigensolve holds about this many (F, P, P)
# arrays at once: the Gram of the images, the weighted Gram, the
# normalization's outer product and the eigenvectors
_DUAL_GRAMS = 4


def _reconstruct_eig_method(method: str, nf: int, npts: int, dev, dt) -> str:
    """The depth loop's eigensolve for ``reconstruct``: the dense one
    (``eigh``), as the JAX command runs it, unless the dual method's
    (F, P, P) arrays would not fit in the card's free memory (four of
    40 GB at 10k points x 100 views in float32); then ``lowrank``, which
    solves the same rank-12 eigenproblems through their width-12 factors."""
    if method != "dual" or dev.type != "cuda":
        return "eigh"
    grams = _DUAL_GRAMS * nf * npts * npts * torch.empty((), dtype=dt).element_size()
    return "lowrank" if grams > torch.cuda.mem_get_info(dev)[0] else "eigh"


def _cmd_reconstruct(args, out: dict, dev, dt) -> None:
    """``reconstruct``: the euclidean or the affine pipeline on the tracks
    of an npz file (``runtime.io.save_observations``'s layout), the
    alignment error against ``X_gt`` when the file has it, the covariance
    and the writers asked for. A ``visibility`` mask goes to BA only: the
    calibration keeps its full-visibility contract."""
    from .config import LMConfig, as_tensor
    from .models.covariance import ba_covariance
    from .models.pipelines import affine_reconstruction, euclidean_reconstruction
    from .ops.procrustes import aligned_rmse
    from .runtime import io
    from .runtime.profiling import StageTimer

    data = io.load_observations(args.input)
    sharded = _shard_count(args)

    def pts_t(a):
        return _on_host(a, dt) if sharded else as_tensor(a, dev, dt)

    x = pts_t(data["x"])
    nf = x.shape[0]
    f0 = float(data.get("f0", args.f0))
    visibility = None
    if "visibility" in data:
        visibility = pts_t(data["visibility"])
        out["n_visible"] = int(data["visibility"].sum())
    config = LMConfig(scale_factor=args.scale_factor, delta_tol=args.delta_tol,
                      max_iter=args.max_iter)
    timer = StageTimer()
    start = time.perf_counter()
    if sharded:
        from .parallel.pipelines import sharded_euclidean_reconstruction

        res = sharded_euclidean_reconstruction(_points_mesh(args), x, f0=f0, tol=args.tol,
                                               method=args.method, config=config,
                                               visibility=visibility, device=dev, timer=timer)
        out["shard_points"] = args.shard_points
    elif args.pipeline == "euclidean":
        eig_method = _reconstruct_eig_method(args.method, nf, x.shape[1], dev, dt)
        out["eig_method"] = eig_method
        res = euclidean_reconstruction(x, f0=f0, tol=args.tol, method=args.method,
                                       config=config, eig_method=eig_method,
                                       visibility=visibility, device=dev, timer=timer)
    else:
        f = as_tensor(data.get("f", np.full((nf,), args.f)), dev, dt)
        # the affine branch takes --f0, not the file's f0, as the JAX command does
        res = affine_reconstruction(x, f, model=args.model, f0=args.f0, config=config,
                                    visibility=visibility, device=dev, timer=timer)
    out.update(status=int(res.status), ba_iterations=int(res.n_iter),
               reprojection_error=float(res.error), n_points=int(res.X.shape[0]),
               n_views=int(nf))
    if "X_gt" in data and _lead(args):
        # the reconstruction is defined up to a similarity: align before the RMSE
        out["aligned_rmse_gt"] = float(aligned_rmse(res.X, as_tensor(data["X_gt"], dev, dt)))
    cov = pt_sig = None
    if args.covariance and _lead(args):
        with timer.stage("covariance"):
            cov = ba_covariance(x.transpose(0, 1), res.X, res.K, res.R, res.t, f0=f0,
                                visibility=visibility, axis="x-up_z-forward", device=dev)
        pt_sig = np.sqrt(as_numpy(cov.point_cov).trace(axis1=1, axis2=2) / 3.0)
        out.update(sigma=float(np.sqrt(float(cov.sigma2))),
                   point_sigma_median=float(np.median(pt_sig)),
                   point_sigma_max=float(pt_sig.max()))
    out.update(wall_s=time.perf_counter() - start, stage_walls_s=timer.times)
    if not _lead(args):
        return
    if args.output:
        extra = {}
        if cov is not None:
            extra = dict(point_cov=as_numpy(cov.point_cov), camera_cov=as_numpy(cov.camera_cov),
                         sigma2=as_numpy(cov.sigma2))
        io.save_observations(args.output, data["x"], X=as_numpy(res.X), K=as_numpy(res.K),
                             R=as_numpy(res.R), t=as_numpy(res.t), **extra)
        out["output"] = args.output
    if args.output_ply:
        io.save_ply(args.output_ply, as_numpy(res.X), cameras=as_numpy(res.t), quality=pt_sig)
        out["output_ply"] = args.output_ply


def _cmd_bench_ba(args, out: dict, dev, dt) -> None:
    """``bench-ba``: the dense core, or the chunked one with ``--chunked``,
    for ``--iters`` iterations (``delta_tol`` 0) on a ``--points`` x
    ``--views`` scene from X and t perturbed by 0.05 N(0, 1), drawn from a
    generator seeded with 0. One untimed run (which records the start E
    and builds the kernels), then one timed run ending in a device
    synchronization."""
    import dataclasses

    from .config import LMConfig
    from .geometry.scenes import add_noise, make_synthetic_scene
    from .models.bundle_adjustment import bundle_adjust
    from .models.bundle_adjustment_chunked import bundle_adjust_chunked

    gen = torch.Generator(device=dev).manual_seed(0)
    scene = make_synthetic_scene(gen, n_images=args.views, n_slices=args.points // 20,
                                 n_angles=20, noise=args.noise, dtype=dt)
    X0 = add_noise(gen, scene.X, 0.05)
    t0 = add_noise(gen, scene.t, 0.05)
    x = scene.x.transpose(0, 1)
    cfg = LMConfig(scale_factor=args.scale_factor, delta_tol=0.0, max_iter=args.iters)
    kw = dict(f0=args.f0, axis="x-up_z-forward", device=dev)
    if args.chunked:
        kw["chunk_size"] = args.chunk_size
    ba = bundle_adjust_chunked if args.chunked else bundle_adjust

    warm = ba(x, X0, scene.K, scene.R, t0, config=dataclasses.replace(cfg, record_log=True), **kw)
    start_error = float(warm.log["reprojection_error"][0])
    del warm
    start = time.perf_counter()
    res = ba(x, X0, scene.K, scene.R, t0, config=cfg, **kw)
    err = float(res.error)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out.update(points=args.points, views=args.views, iters=args.iters,
               wall_s=time.perf_counter() - start, reprojection_error=err,
               start_error=start_error, ba_iterations=int(res.n_iter), chunked=args.chunked)
    if args.chunked:
        out["chunk_size"] = args.chunk_size


_COMMANDS = {"euclidean": _cmd_synthetic, "affine": _cmd_synthetic, "batch": _cmd_synthetic,
             "euclidean-large": _cmd_synthetic, "reconstruct": _cmd_reconstruct,
             "bal": _cmd_bal, "bench-ba": _cmd_bench_ba}


def main(argv=None) -> int:
    """Parse ``argv``, run the subcommand, print its record (and append it
    to ``--log-json``). Returns 0; a failure raises."""
    from .config import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    dt = torch.float64 if args.float64 else torch.float32
    out: dict = {"command": args.command}
    t_start = time.perf_counter()
    with contextlib.ExitStack() as stack:
        n_shards = _shard_count(args)
        if n_shards:
            from .runtime.distributed import join_ranks, local_device

            if join_ranks(n_shards, "cpu" if dev.type == "cpu" else None):
                stack.callback(torch.distributed.destroy_process_group)
            if dev.type == "cuda":
                dev = local_device()  # the rank's own card
        if args.profile:
            from .runtime.profiling import capture_trace

            stack.enter_context(capture_trace(args.profile))
            out["profile_dir"] = args.profile
        _COMMANDS[args.command](args, out, dev, dt)
        lead = _lead(args)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out["dtype"] = str(dt).removeprefix("torch.")
    out["total_wall_s"] = round(time.perf_counter() - t_start, 2)
    line = json.dumps(out)
    if args.log_json and lead:
        with open(args.log_json, "a") as fh:
            fh.write(line + "\n")
    if lead:
        print(line)
    return 0
