#!/usr/bin/env python3
"""The float32 rounding noise of a distorted BA run on ``chip_smoke.py``'s
phase-5 problem, on the CPU alone: the port's dense core with one shared
refit round and one iteration a segment (phase 5's configuration), run in
float32 and float64, with the points in their order and reversed. The
relative differences of the final E from the float64 run bound how far the
card and the CPU may part on this problem without a fault in either: the
rounding is the same algorithm's, summed in another order.

Usage: python3 scripts/distortion_float32_noise.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mvrecon_tpu_torch.config import LMConfig  # noqa: E402
from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene  # noqa: E402
from mvrecon_tpu_torch.models import bundle_adjustment as tba  # noqa: E402


def main() -> None:
    # phase 5's scene, start and renders (chip_smoke.distortion_gpu_vs_cpu)
    gen = torch.Generator().manual_seed(34)
    sc = make_synthetic_scene(gen, n_images=8, n_slices=4, n_angles=20, dtype=torch.float32)
    truth = cs.true_state(tba, sc)
    X0, K, R, t0 = cs.perturbed_cameras(sc, seed=34)
    for model, k in (("radial", cs.RADIAL_TRUTH), ("opencv", cs.OPENCV_TRUTH)):
        dist = torch.tensor(k).expand(8, len(k))
        x = cs.render_distorted(torch, tba, truth, dist, gen, 0, sc.X.shape[0])[0].numpy()
        cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=1, distortion_rounds=1,
                       distortion_shared=True, distortion_model=model)
        errors = {}
        for order, idx in (("points_in_order", slice(None)),
                           ("points_reversed", slice(None, None, -1))):
            for dt in (np.float32, np.float64):
                args = [np.ascontiguousarray(a).astype(dt) for a in (x[idx], X0[idx], K, R, t0)]
                res = tba.bundle_adjust(*args, axis="x-up_z-forward", config=cfg, device="cpu")
                errors[f"{order}_{dt.__name__}"] = float(res.error)
        ref = errors["points_in_order_float64"]
        f32 = [errors["points_in_order_float32"], errors["points_reversed_float32"]]
        print(json.dumps({
            "model": model, "E": errors,
            "float32_vs_float64_rel": [abs(e - ref) / ref for e in f32],
            "float32_order_rel": abs(f32[0] - f32[1]) / ref,
        }), flush=True)


if __name__ == "__main__":
    main()
