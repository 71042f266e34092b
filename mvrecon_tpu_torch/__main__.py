"""Command line of the port. Each subcommand builds synthetic scenes, runs
one pipeline and prints one JSON record:

    python -m mvrecon_tpu_torch euclidean --n-images 10 --method dual
    python -m mvrecon_tpu_torch euclidean-large --n-points 2000 --n-images 16
    python -m mvrecon_tpu_torch affine --model paraperspective --n-images 12
    python -m mvrecon_tpu_torch batch --scenes 8 --n-images 10 --scene-chunk 4
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
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
