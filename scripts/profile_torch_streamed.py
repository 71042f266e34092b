#!/usr/bin/env python3
"""Where the time of the port's host-streamed BA goes, on one CUDA card.

Builds the streamed design point (the curved tube at 1M points x 500
views, float32), moves its (P, F, 2) observations to host memory, warms
up on a small scene, then traces ``--iters`` BA iterations of
``bundle_adjust_streamed`` (chunk 16384, prefetch 2) with
``torch.profiler``. Prints one JSON line: the host wall, the summed
device time of all kernels and copies, the share of the wall in which
the compute stream runs no kernel (copies run on their own stream), and the
device time by group (K1, host-to-device copies, cuBLAS, elementwise,
Cholesky) and of the top kernels; writes the full kernel table to
``--out`` (default ``build/profile_torch_streamed.txt``).

    python3 scripts/profile_torch_streamed.py [--points N] [--iters K] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

VIEWS = 500
CHUNK = 16384


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=1_000_000)
    parser.add_argument("--iters", type=int, default=1)
    parser.add_argument("--out", default="build/profile_torch_streamed.txt")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvrecon_tpu_torch.config import LMConfig, resolve_device
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed
    from mvrecon_tpu_torch.ops import _cuda_build

    dev = resolve_device(None)
    _cuda_build.build()

    def host_problem(points, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        sc = make_synthetic_scene(gen, n_images=VIEWS, n_slices=points // 20, n_angles=20,
                                  dtype=torch.float32)
        rng = np.random.default_rng(seed)
        X, K, R, t = (a.cpu().numpy() for a in (sc.X, sc.K, sc.R, sc.t))
        x = sc.x.transpose(0, 1).contiguous().cpu().numpy()
        X0 = (X + 0.02 * rng.standard_normal(X.shape)).astype(np.float32)
        t0 = (t + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
        return x, X0, K, R, t0

    def run(prob, iters):
        cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=iters)
        res = bundle_adjust_streamed(*prob, axis="x-up_z-forward", config=cfg,
                                     chunk_size=CHUNK, prefetch=2)
        float(res.error)
        return res

    run(host_problem(2 * CHUNK, seed=1), 1)
    prob = host_problem(args.points, seed=4)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        res = run(prob, args.iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device events only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    kernels.sort(key=dev_us, reverse=True)
    busy_s = sum(dev_us(e) for e in kernels) / 1e6
    groups = {"syrk_lower (K1)": ("syrk_lower",),
              "host-to-device copies": ("Memcpy HtoD",),
              "cholesky factor/solve": ("potrf", "getrf", "trsm", "potrs", "herk"),
              "cuBLAS products": ("gemm", "gemv", "xmma", "Gemm"),
              "elementwise/reduction/copy": ("at::native", "Memcpy", "Memset")}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for e in kernels:
        name = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        by_group[name] += dev_us(e) / 1e3
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    # the copies run on their own stream, beside the computation
    compute_s = busy_s - by_group["host-to-device copies"] / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "points": prob[0].shape[0], "views": VIEWS,
        "chunk": CHUNK, "ba_iters": res.n_iter, "ba_solver_retries": res.log["n_solver_retries"],
        "wall_s": wall, "device_busy_s": busy_s, "compute_busy_s": compute_s,
        "compute_idle_share": 1.0 - compute_s / wall,
        "device_ms_by_group": by_group, "device_events": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:80]: dev_us(e) / 1e3 for e in kernels[:15]},
        "top_kernels_calls": {e.key[:80]: e.count for e in kernels[:15]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
