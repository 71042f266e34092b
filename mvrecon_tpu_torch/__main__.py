"""Command line of the port. Each subcommand runs one pipeline and prints
one JSON record; ``bal`` bundle-adjusts a problem read from disk (a BAL
file or a COLMAP model), the others build synthetic scenes:

    python -m mvrecon_tpu_torch euclidean --n-images 10 --method dual
    python -m mvrecon_tpu_torch euclidean-large --n-points 2000 --n-images 16
    python -m mvrecon_tpu_torch affine --model paraperspective --n-images 12
    python -m mvrecon_tpu_torch batch --scenes 8 --n-images 10 --scene-chunk 4
    python -m mvrecon_tpu_torch bal sparse/0 --chunk-size 768 --optimize-distortion 1
    python -m mvrecon_tpu_torch bal problem.bal --sparse --huber 0.02 --triangulate-init
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

NOISE = 0.005  # image noise of the synthetic scenes


def _scene_args(p: argparse.ArgumentParser, n_points: int, n_images: int, seed: int) -> None:
    p.add_argument("--n-points", type=int, default=n_points,
                   help="points (the curved tube gets n_points // 20 slices of 20)")
    p.add_argument("--n-images", type=int, default=n_images)
    p.add_argument("--seed", type=int, default=seed)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--float64", action="store_true")


def _lm_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max-iter", type=int, default=100, help="BA iterations")
    p.add_argument("--delta-tol", type=float, default=1e-8)
    p.add_argument("--scale-factor", type=float, default=2.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvrecon_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("euclidean", help="self-calibration + dense BA on a synthetic scene")
    _scene_args(p, n_points=200, n_images=10, seed=123)
    p.add_argument("--method", choices=["primary", "dual"], default="dual")
    p.add_argument("--tol", type=float, default=1e-2)
    p.add_argument("--eig-method", choices=["eigh", "lowrank", "power"], default="eigh")
    _lm_args(p)

    p = sub.add_parser("affine", help="affine self-calibration + dense BA on a synthetic scene")
    _scene_args(p, n_points=200, n_images=12, seed=123)
    p.add_argument("--model", choices=["orthographic", "symmetric", "paraperspective"],
                   default="paraperspective")
    p.add_argument("--f", type=float, default=1.0, help="focal length of the scene")
    _lm_args(p)

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
    _bal_args(sub.add_parser("bal", help="bundle-adjust a BAL problem file or a COLMAP model"))
    return parser


def _bal_args(p: argparse.ArgumentParser) -> None:
    """The flags of ``bal``, as the JAX package's command line has them."""
    p.add_argument("input", help="BAL text file (Agarwal et al. ECCV 2010 format), or a "
                   "directory holding a COLMAP model, binary or text")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--float64", action="store_true")
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
    p.add_argument("--shard-points", type=int, default=0, metavar="N",
                   help="shard the points over N devices (not ported yet)")
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


def _cmd_bal(args) -> int:
    """``bal``: load the problem, run the dense or the chunked core, and the
    covariance and the writers asked for; one JSON record under the JAX
    package's keys."""
    import functools
    import os

    import numpy as np

    from .config import LMConfig, as_tensor, resolve_device
    from .models.bundle_adjustment import bundle_adjust, undistort_points
    from .models.bundle_adjustment_chunked import bundle_adjust_chunked
    from .models.covariance import ba_covariance, ba_covariance_chunked
    from .runtime import io

    if args.shard_points > 0:
        raise NotImplementedError("bal --shard-points: the sharded cores are not ported yet "
                                  "(ROADMAP queue 1, item 10)")
    dev = resolve_device(args.device)
    dt = torch.float64 if args.float64 else torch.float32
    out: dict = {"command": "bal"}
    t_start = time.perf_counter()
    if args.sparse:
        _cmd_bal_sparse(args, out, dev, dt)
        return _finish(out, dev, dt, t_start)
    if args.chunk_size > 0:
        ba_fn = functools.partial(bundle_adjust_chunked, chunk_size=args.chunk_size)
        cov_fn = functools.partial(ba_covariance_chunked, chunk_size=args.chunk_size)
    else:
        ba_fn, cov_fn = bundle_adjust, ba_covariance
    if os.path.isdir(args.input):
        d = io.load_colmap(args.input)
        out["format"] = "colmap"
    else:
        d = io.load_bal(args.input)

    def dev_t(a):
        return as_tensor(np.ascontiguousarray(a), dev, dt)

    def host(a):
        return a.detach().cpu().numpy()

    x = dev_t(d["x"].transpose(1, 0, 2))  # (P, F, 2)
    vis = dev_t(d["visibility"])
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
    res = ba_fn(x, dev_t(d["X"]), dev_t(d["K"]), dev_t(d["R"]), dev_t(d["t"]),
                distortion=dist, **common)
    out.update(cams=int(vis.shape[1]), points=int(vis.shape[0]),
               observations=int(d["visibility"].sum()), ba_iterations=int(res.n_iter),
               reprojection_error=float(res.error))
    X, K, R, t = (host(a) for a in (res.X, res.K, res.R, res.t))
    cov = pt_sig = None
    if args.covariance:
        cov = cov_fn(x, res.X, res.K, res.R, res.t, distortion=res.distortion, **common)
        pt_sig = np.sqrt(host(cov.point_cov).trace(axis1=1, axis2=2) / 3.0)
        cam_t_sig = np.sqrt(host(cov.camera_cov)[:, 3:6, 3:6].trace(axis1=1, axis2=2) / 3.0)
        out.update(sigma=float(np.sqrt(float(cov.sigma2))),
                   point_sigma_median=float(np.median(pt_sig)),
                   point_sigma_max=float(pt_sig.max()),
                   camera_pos_sigma_median=float(np.median(cam_t_sig)))
    dmat = None if res.distortion is None else host(res.distortion)
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
            extra.update(point_cov=host(cov.point_cov), camera_cov=host(cov.camera_cov),
                         sigma2=host(cov.sigma2))
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
            x, res.K[:, 0, 0], res.K[:, :2, 2], f0=f0, distortion=dev_t(dist_out),
            distortion_model=in_model)
        io.save_colmap(args.output_colmap_pinhole, host(x_un).transpose(1, 0, 2),
                       d["visibility"], X, R, t, K[:, 0, 0], principal_point=K[:, :2, 2])
        out["output_colmap_pinhole"] = args.output_colmap_pinhole
    if args.output_ply:
        io.save_ply(args.output_ply, X, cameras=t, quality=pt_sig)
        out["output_ply"] = args.output_ply
    return _finish(out, dev, dt, t_start)


def _finish(out: dict, dev, dt, t_start: float) -> int:
    """Add the device, dtype and wall to the record and print it."""
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out["dtype"] = str(dt).removeprefix("torch.")
    out["total_wall_s"] = round(time.perf_counter() - t_start, 2)
    print(json.dumps(out))
    return 0


def _cmd_bal_sparse(args, out: dict, dev, dt) -> None:
    """``bal --sparse``: the O(n_obs) path. The BAL file loads straight
    into the observation list (no dense arrays), the sparse core optimizes
    it (from the file's points or a DLT triangulation), and PLY and BAL are
    written from the list; the record carries the JAX package's keys."""
    import os

    import numpy as np

    from .config import LMConfig, as_tensor
    from .models.bundle_adjustment_sparse import SparseObs, bundle_adjust_sparse
    from .ops.triangulation import triangulate_sparse
    from .runtime import io

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
    pi = torch.from_numpy(d["point_idx"].astype(np.int32)).to(dev)
    ci = torch.from_numpy(d["cam_idx"].astype(np.int32)).to(dev)
    xy = dev_t(d["xy"])  # (N, 2)
    if args.triangulate_init:
        X0 = triangulate_sparse(pi, ci, xy, npts, K0, R0, t0, f0=f0, device=dev)
        out["triangulate_init"] = True
    else:
        X0 = dev_t(d["X"])
    obs = SparseObs(pi, ci, xy.T.contiguous(), torch.ones(pi.shape[0], dtype=dt, device=dev))
    res = bundle_adjust_sparse(
        obs, X0, K0, R0, t0, f0=f0, axis="x-up_z-forward", config=cfg,
        cg_max_iter=args.cg_max_iter, distortion=dist,
        factor_dtype="bfloat16" if args.bf16_factors else None,
        factor_mode="recompute" if args.recompute_factors else "stored", device=dev)
    if args.bf16_factors:
        out["factor_dtype"] = "bfloat16"
    if args.recompute_factors:
        out["factor_mode"] = "recompute"
    out.update(format="bal", sparse=True, cams=nf, points=npts,
               observations=int(d["point_idx"].shape[0]), ba_iterations=int(res.n_iter),
               cg_iterations=int(res.log["cg_iters_total"]),
               reprojection_error=float(res.error))
    dmat = None if res.distortion is None else res.distortion.cpu().numpy()
    if dmat is not None:
        out["k1_mean"] = float(dmat[:, 0].mean())
        out["k2_mean"] = float(dmat[:, 1].mean())
    X, R, t = (a.detach().cpu().numpy() for a in (res.X, res.R, res.t))
    if args.output_ply:
        io.save_ply(args.output_ply, X, cameras=t)
        out["output_ply"] = args.output_ply
    if args.output_bal:
        dist_out = dmat if dmat is not None else (None if args.ignore_distortion
                                                  else d["distortion"])
        io.save_bal_sparse(args.output_bal, d["point_idx"], d["cam_idx"], d["xy"], npts, X, R, t,
                           res.K[:, 0, 0].cpu().numpy(), distortion=dist_out)
        out["output_bal"] = args.output_bal


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "bal":
        return _cmd_bal(args)
    from .config import LMConfig, resolve_device
    from .geometry.scenes import make_synthetic_scene
    from .models.pipelines import (
        affine_reconstruction,
        euclidean_reconstruction,
        euclidean_reconstruction_large,
    )
    from .parallel.batched import batched_euclidean_reconstruction
    from .runtime.profiling import StageTimer

    dev = resolve_device(args.device)
    dt = torch.float64 if args.float64 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def scene():
        return make_synthetic_scene(gen, n_images=args.n_images,
                                    n_slices=max(1, args.n_points // 20), n_angles=20,
                                    f=getattr(args, "f", 1.0), noise=NOISE, dtype=dt)

    timer = StageTimer()
    start = time.perf_counter()
    if args.command == "batch":
        x = torch.stack([scene().x for _ in range(args.scenes)])
        n_points = x.shape[2]
    else:
        sc = scene()
        n_points = sc.X.shape[0]
    if args.command in ("euclidean", "affine", "batch"):
        config = LMConfig(scale_factor=args.scale_factor, delta_tol=args.delta_tol,
                          max_iter=args.max_iter)
    if args.command == "euclidean":
        res = euclidean_reconstruction(sc.x, tol=args.tol, method=args.method, config=config,
                                       eig_method=args.eig_method, device=dev, timer=timer)
        extra = {"method": args.method, "eig_method": args.eig_method}
    elif args.command == "affine":
        f = torch.full((args.n_images,), args.f, dtype=dt, device=dev)
        res = affine_reconstruction(sc.x, f, model=args.model, config=config, device=dev,
                                    timer=timer)
        extra = {"model": args.model}
    elif args.command == "batch":
        res = batched_euclidean_reconstruction(
            x, tol=args.tol, method=args.method, config=config, eig_method=args.eig_method,
            scene_chunk=args.scene_chunk, device=dev, timer=timer,
        )
        extra = {"scenes": args.scenes, "scene_chunk": args.scene_chunk,
                 "method": args.method, "eig_method": args.eig_method,
                 "statuses": res.status.tolist(), "ba_n_iters": res.n_iter.tolist(),
                 "reprojection_errors": res.error.tolist(),
                 "ba_solver_retries": res.ba_log["n_solver_retries"]}
    else:
        config = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=args.max_iter,
                          accept_divisor=1.0, init_damping=3e-3, damping="nielsen")
        res = euclidean_reconstruction_large(sc.x, config=config, chunk_size=args.chunk_size,
                                             device=dev, timer=timer)
        extra = {"chunk_size": args.chunk_size,
                 "ba_solver_retries": res.ba_log["n_solver_retries"]}
    if args.command == "batch":
        err = res.error.max().item()  # the worst scene
        status, n_iter = res.status.max().item(), res.n_iter.max().item()
    else:
        err, status, n_iter = float(res.error), res.status, res.n_iter
    wall = time.perf_counter() - start
    floor = n_points * args.n_images * 2 * NOISE**2
    print(json.dumps({
        "command": args.command, "points": n_points, "views": args.n_images, **extra,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": str(dt).removeprefix("torch."),
        "wall_s": wall, "stage_walls_s": timer.times,
        "calib_status": status, "ba_n_iter": n_iter,
        "reprojection_error": err, "E_vs_noise_floor": err / floor,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
