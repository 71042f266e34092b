"""Command line of the port: ``python -m mvrecon_tpu_torch euclidean-large``
builds a synthetic scene, runs the large perspective pipeline and prints
one JSON record."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvrecon_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("euclidean-large",
                       help="self-calibration + chunked BA on a synthetic scene")
    p.add_argument("--n-points", type=int, default=2000,
                   help="points (the curved tube gets n_points // 20 slices of 20)")
    p.add_argument("--n-images", type=int, default=16)
    p.add_argument("--chunk-size", type=int, default=768)
    p.add_argument("--max-iter", type=int, default=8, help="BA iterations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--float64", action="store_true")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .config import LMConfig, resolve_device
    from .geometry.scenes import make_synthetic_scene
    from .models.pipelines import euclidean_reconstruction_large
    from .runtime.profiling import StageTimer

    dev = resolve_device(args.device)
    dt = torch.float64 if args.float64 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    scene = make_synthetic_scene(gen, n_images=args.n_images,
                                 n_slices=max(1, args.n_points // 20), n_angles=20, dtype=dt)
    config = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=args.max_iter,
                      accept_divisor=1.0, init_damping=3e-3, damping="nielsen")
    timer = StageTimer()
    start = time.perf_counter()
    res = euclidean_reconstruction_large(scene.x, config=config, chunk_size=args.chunk_size,
                                         device=dev, timer=timer)
    err = float(res.error)
    wall = time.perf_counter() - start
    n_points, n_views = scene.X.shape[0], args.n_images
    floor = n_points * n_views * 2 * 0.005**2
    print(json.dumps({
        "points": n_points, "views": n_views, "chunk_size": args.chunk_size,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": str(dt).removeprefix("torch."),
        "wall_s": wall, "stage_walls_s": timer.times,
        "calib_status": res.status, "ba_n_iter": res.n_iter,
        "ba_solver_retries": res.ba_log["n_solver_retries"],
        "reprojection_error": err, "E_vs_noise_floor": err / floor,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
