#!/usr/bin/env python3
"""How well the refit alternation recovers a distortion on the synthetic
curved-tube scene, with the port's dense core on the CPU.

The scene (cameras at radius 5 around a tube of radius about 0.5, f = 1)
sees its points at normalized radii |rho| below about 0.6, so s = |rho|^2
stays small and the quartic k2 s^2 trades against k1 s and the geometry at
an equal E. This script renders ``chip_smoke.py``'s shared truths (BAL
radial (-0.3, 0.05), OPENCV (-0.28, 0.035, 0.018, -0.012)) into one scene,
runs ``bundle_adjust`` from zero with the given rounds and iterations
(phase 4n's Nielsen settings, or phase 4p's reference damping with
``--reference``), and prints one JSON line per model: the largest s, E
over the noise floor, the recovered k, its largest error against the
truth, and ``chip_smoke.model_error`` (the RMS error of the recovered
model's displacement over the true one's, on the scene's rays).

Usage: python3 scripts/distortion_identifiability.py [--views 100]
       [--points 4000] [--rounds 2] [--iters 5] [--seed 0] [--reference]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mvrecon_tpu_torch.config import LMConfig  # noqa: E402
from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene  # noqa: E402
from mvrecon_tpu_torch.models import bundle_adjustment as tba  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--views", type=int, default=100)
    parser.add_argument("--points", type=int, default=4000)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reference", action="store_true",
                        help="reference damping (scale_factor 2), as phase 4p")
    args = parser.parse_args()
    damping = (dict(scale_factor=2.0) if args.reference else
               dict(scale_factor=4.0, accept_divisor=1.0, init_damping=3e-3, damping="nielsen"))
    scene = make_synthetic_scene(torch.Generator().manual_seed(args.seed), n_images=args.views,
                                 n_slices=args.points // 20, n_angles=20, dtype=torch.float32)
    truth = cs.true_state(tba, scene)
    start = cs.perturbed_cameras(scene, seed=31)
    npts = scene.X.shape[0]
    for model, k in (("radial", cs.RADIAL_TRUTH), ("opencv", cs.OPENCV_TRUTH)):
        dist = torch.tensor(k).expand(args.views, len(k))
        x = torch.empty((npts, args.views, 2))
        s_max = cs.render_all(torch, tba, truth, dist, torch.Generator().manual_seed(31), x)
        cfg = LMConfig(delta_tol=0.0, max_iter=args.iters, distortion_rounds=args.rounds,
                       distortion_shared=True, distortion_model=model, **damping)
        t0 = time.perf_counter()
        res = tba.bundle_adjust(x, *start, axis="x-up_z-forward", config=cfg, device="cpu")
        print(json.dumps({
            "model": model, "views": args.views, "points": npts, "rounds": args.rounds,
            "iters_per_segment": args.iters, "reference_damping": args.reference,
            "s_max": s_max, "E_vs_noise_floor": float(res.error) / (npts * args.views * 2
                                                                     * cs.NOISE**2),
            "k": res.distortion[0].tolist(), "k_true": list(k),
            "k_max_abs_err": cs.k_error(res, k),
            "model_rms_rel_err": cs.model_error(torch, tba, truth, res.distortion, dist),
            "cpu_wall_s": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
