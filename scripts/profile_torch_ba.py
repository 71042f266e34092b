#!/usr/bin/env python3
"""Where the time of the port's chunked BA goes, on one CUDA card.

Builds the north-star scene (100k points x 1000 views by default), runs
the port's self-calibration for the BA start, warms up with one BA
iteration, then traces ``--iters`` BA iterations with ``torch.profiler``.
Prints one JSON line: the host wall, the summed device time of all
kernels, the device idle share, and the device time of the top kernels;
writes the full kernel table to ``--out`` (default
``build/profile_torch_ba.txt``).

    python3 scripts/profile_torch_ba.py [--points N] [--views F] [--iters K] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=100_000)
    parser.add_argument("--views", type=int, default=1000)
    parser.add_argument("--chunk", type=int, default=768)
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--out", default="build/profile_torch_ba.txt")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvrecon_tpu_torch.config import LMConfig, resolve_device
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.perspective import perspective_self_calibration

    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(0)
    scene = make_synthetic_scene(gen, n_images=args.views, n_slices=args.points // 20,
                                 n_angles=20, dtype=torch.float32)
    calib = perspective_self_calibration(scene.x, tol=1e-2, method="dual",
                                         eig_method="lowrank")
    x_pf = scene.x.transpose(0, 1)

    def run(iters):
        cfg = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=iters, accept_divisor=1.0,
                       init_damping=3e-3, damping="nielsen")
        res = bundle_adjust_chunked(x_pf, calib.X, calib.K, calib.R, calib.t,
                                    axis="x-up_z-forward", config=cfg, chunk_size=args.chunk)
        float(res.error)
        return res

    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        res = run(args.iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernel events only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    kernels.sort(key=dev_us, reverse=True)
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    groups = {"syrk_acc (K2)": ("syrk_acc_kernel",),
              "cholesky factor/solve": ("potrf", "getrf", "trsm", "potrs", "syrk", "herk"),
              "cuBLAS products": ("gemm", "gemv", "xmma", "Gemm"),
              "elementwise/reduction/copy": ("at::native",)}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for e in kernels:
        name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        by_group[name] += dev_us(e) / 1e3
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "points": scene.X.shape[0],
        "views": args.views, "chunk": args.chunk, "ba_iters": res.n_iter,
        "ba_solver_retries": res.log["n_solver_retries"], "wall_s": wall,
        "device_busy_s": busy_s, "device_idle_share": 1.0 - busy_s / wall,
        "device_ms_by_group": by_group, "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:80]: dev_us(e) / 1e3 for e in kernels[:15]},
        "top_kernels_calls": {e.key[:80]: e.count for e in kernels[:15]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
