#!/usr/bin/env python3
"""Time the port's dense BA at chip_smoke phase 4c's problem (10k points x
100 views, float32, 10 iterations, X and t perturbed by 0.05 N(0, 1)) and
the dense pipeline on its observations, on the card.

    PYTHONPATH=<tree> python3 scripts/dense_wall.py --reps 5

imports ``mvrecon_tpu_torch`` from the tree on PYTHONPATH, so two trees
(a parent unpacked under ``build/parent`` and the working tree) can be
timed in turns in one call. Prints one JSON line: the walls of each run,
the median derivative-build time (CUDA events) and E / noise floor.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--points", type=int, default=10_000)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dense_wall: no CUDA device")
    import mvrecon_tpu_torch
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction

    views = 100
    gen = torch.Generator(device="cuda").manual_seed(3)
    sc = make_synthetic_scene(gen, n_images=views, n_slices=args.points // 20, n_angles=20)
    rng = np.random.default_rng(3)
    X, K, R, t = (a.cpu().numpy() for a in (sc.X, sc.K, sc.R, sc.t))
    x = sc.x.transpose(0, 1).contiguous().cpu().numpy()
    X0 = (X + 0.05 * rng.standard_normal(X.shape)).astype(X.dtype)
    t0 = (t + 0.05 * rng.standard_normal(t.shape)).astype(t.dtype)
    start = [torch.from_numpy(a).cuda() for a in (x, X0, K, R, t0)]
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=10)
    floor = X.shape[0] * views * 2 * 0.005**2

    def timed(fn):
        torch.cuda.synchronize()
        t_0 = time.perf_counter()
        out = fn()
        err = float(out.error)
        return time.perf_counter() - t_0, err

    ba = lambda: tba.bundle_adjust(*start, axis="x-up_z-forward", config=cfg)  # noqa: E731
    pipe = lambda: euclidean_reconstruction(sc.x, method="dual", eig_method="lowrank",  # noqa: E731
                                            config=cfg)
    ba(), pipe()  # warm-up
    ba_runs = [timed(ba) for _ in range(args.reps)]
    pipe_runs = [timed(pipe) for _ in range(args.reps)]

    xt, vis, state, free, _ = tba._prepare_problem(*start, 1.0, None, "x-up_z-forward", "cuda")
    times = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        tba._compute_derivs(state, xt, vis, free, 1.0)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    print(json.dumps({
        "tree": mvrecon_tpu_torch.__file__, "device": torch.cuda.get_device_name(0),
        "dense_ba_wall_s": [w for w, _ in ba_runs],
        "dense_ba_E_vs_noise_floor": ba_runs[0][1] / floor,
        "dense_pipeline_wall_s": [w for w, _ in pipe_runs],
        "derivs_ms_median": statistics.median(times),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
