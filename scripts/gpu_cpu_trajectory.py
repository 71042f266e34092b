#!/usr/bin/env python3
"""How far the port's small-scene pipeline on the card drifts from the CPU's.

Runs ``euclidean_reconstruction_large`` of ``mvrecon_tpu_torch`` on the
12-view, 400-point scene of ``chip_smoke.py`` phase 5 with the north-star
BA config (8 iterations), and prints one JSON line per run with the
reprojection error E after every BA iteration and the solver retries:

- ``pipeline``: the whole pipeline on the card in float32, on the CPU in
  float32 at chunk sizes 128, 64 and 400 (the same algebra summed in
  another order), and on the CPU in float64;
- ``same_start``: BA alone from one calibration (the CPU's, float32), on
  the card and on the CPU, which takes the calibration out of the gap;
- ``calibration``: the calibration on the card and the CPU, float32, held
  against each other on sign-invariant quantities;
- ``dense``: the dense ``bundle_adjust`` from the starts of ``chip_smoke.py``
  phase 5 (point side: 12 views x 400 points; camera side: 100 views x
  200 points, 3P < 9F), reference damping, on the card and on the CPU in
  float32, on the CPU with the points in reverse order (the same algebra
  summed in another order) and in float64.

The spread between the CPU's own float32 runs is the yardstick for the gap
between the card and the CPU.

    python3 scripts/gpu_cpu_trajectory.py [--device cuda] [--iters 8]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=8)
    args = parser.parse_args()

    import torch

    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.camera import project_points
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu_torch.models.perspective import perspective_self_calibration
    from mvrecon_tpu_torch.models.pipelines import euclidean_reconstruction_large

    config = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=args.iters,
                      accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
                      record_log=True)
    scene = make_synthetic_scene(torch.Generator().manual_seed(1), n_images=12,
                                 n_slices=20, n_angles=20, dtype=torch.float32)

    def record(kind, name, res):
        log = res.log if hasattr(res, "log") else res.ba_log
        rec = {"kind": kind, "run": name, "n_iter": res.n_iter,
               "retries": log["n_solver_retries"], "E": float(res.error),
               "E_log": log["reprojection_error"].tolist()}
        if hasattr(res, "status"):
            rec["status"] = res.status
        print(json.dumps(rec), flush=True)
        return rec

    runs = [(args.device, torch.float32, 128), ("cpu", torch.float32, 128),
            ("cpu", torch.float32, 64), ("cpu", torch.float32, 400),
            ("cpu", torch.float64, 128)]
    for dev, dt, chunk in runs:
        res = euclidean_reconstruction_large(scene.x.to(dt), config=config,
                                             chunk_size=chunk, device=dev)
        record("pipeline", f"{dev} {str(dt)[6:]} chunk {chunk}", res)

    calib = {dev: perspective_self_calibration(scene.x, tol=1e-2, method="dual",
                                               eig_method="lowrank", device=dev)
             for dev in (args.device, "cpu")}
    proj = {dev: project_points(c.X.cpu(), c.K.cpu(), c.R.cpu(), c.t.cpu())
            for dev, c in calib.items()}
    a, b = proj[args.device], proj["cpu"]
    print(json.dumps({
        "kind": "calibration",
        "status": [calib[d].status for d in (args.device, "cpu")],
        "depth_iters": [calib[d].depth_iters for d in (args.device, "cpu")],
        "depth_error": [float(calib[d].depth_error) for d in (args.device, "cpu")],
        "projection_max_rel_diff": float((a - b).abs().max() / b.abs().max()),
    }), flush=True)

    c = calib["cpu"]
    x_pf = scene.x.transpose(0, 1)
    for dev in (args.device, "cpu"):
        res = bundle_adjust_chunked(x_pf, c.X, c.K, c.R, c.t, axis="x-up_z-forward",
                                    config=config, chunk_size=128,
                                    device=dev)
        record("same_start", f"{dev} float32 chunk 128", res)

    from chip_smoke import perturbed_start
    from mvrecon_tpu_torch.models.bundle_adjustment import bundle_adjust

    dense_cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=args.iters, record_log=True)
    for side, (nf, n_slices) in {"point": (12, 20), "camera": (100, 10)}.items():
        sc = make_synthetic_scene(torch.Generator().manual_seed(6), n_images=nf,
                                  n_slices=n_slices, n_angles=20, dtype=torch.float32)
        x, X0, K, R, t0 = perturbed_start(sc, seed=6)
        starts = {f"{args.device} float32": (args.device, (x, X0, K, R, t0)),
                  "cpu float32": ("cpu", (x, X0, K, R, t0)),
                  "cpu float32 points reversed": ("cpu", (x[::-1].copy(), X0[::-1].copy(),
                                                          K, R, t0)),
                  "cpu float64": ("cpu", tuple(a.astype("float64") for a in (x, X0, K, R, t0)))}
        for name, (dev, start) in starts.items():
            res = bundle_adjust(*start, axis="x-up_z-forward", config=dense_cfg, device=dev)
            print(json.dumps({"kind": "dense", "side": side, "run": name, "n_iter": res.n_iter,
                              "E_log": res.log["reprojection_error"].tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
