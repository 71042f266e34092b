#!/usr/bin/env python3
"""The float32 rounding noise of a distorted BA run on ``chip_smoke.py``'s
phase-5 problem, on the CPU alone, for each of the six distortion families
(the radial and OPENCV truths and ``chip_smoke.FAMILY_TRUTHS``): the port's
dense core with one shared refit round and one iteration a segment (phase
5's configuration), run in float32 and float64, with the points in their
order, reversed and in four seeded permutations, and the chunked core
(chunk 32) in float32. The relative differences of the final E from the
float64 run, and the spread of the float32 runs, bound how far the card
and the CPU may part on this problem without a fault in either: the
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
from mvrecon_tpu_torch.models.bundle_adjustment_chunked import bundle_adjust_chunked  # noqa: E402


def main() -> None:
    # phase 5's scene, start and renders (chip_smoke.distortion_gpu_vs_cpu)
    gen = torch.Generator().manual_seed(34)
    sc = make_synthetic_scene(gen, n_images=8, n_slices=4, n_angles=20, dtype=torch.float32)
    truth = cs.true_state(tba, sc)
    X0, K, R, t0 = cs.perturbed_cameras(sc, seed=34)
    families = (("radial", cs.RADIAL_TRUTH), ("opencv", cs.OPENCV_TRUTH),
                *cs.FAMILY_TRUTHS.items())
    for model, k in families:
        dist = torch.tensor(k).expand(8, len(k))
        x = cs.render_distorted(torch, tba, truth, dist, gen, 0, sc.X.shape[0], model)[0].numpy()
        cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=1, distortion_rounds=1,
                       distortion_shared=True, distortion_model=model)
        errors = {}
        perm = np.random.default_rng(0)
        orders = [("points_in_order", np.arange(x.shape[0])),
                  ("points_reversed", np.arange(x.shape[0])[::-1])]
        orders += [(f"points_permuted_{i}", perm.permutation(x.shape[0])) for i in range(4)]
        for order, idx in orders:
            for dt in (np.float32, np.float64):
                args = [np.ascontiguousarray(a).astype(dt) for a in (x[idx], X0[idx], K, R, t0)]
                res = tba.bundle_adjust(*args, axis="x-up_z-forward", config=cfg, device="cpu")
                errors[f"{order}_{dt.__name__}"] = float(res.error)
        # the chunked core's sums (phase 5's chunk of 32), in float32
        args = [np.ascontiguousarray(a).astype(np.float32) for a in (x, X0, K, R, t0)]
        res = bundle_adjust_chunked(*args, axis="x-up_z-forward", config=cfg, chunk_size=32,
                                    device="cpu")
        errors["chunked_float32"] = float(res.error)
        ref = errors["points_in_order_float64"]
        f32 = [e for key, e in errors.items() if key.endswith("float32")]
        f32_rel = [abs(e - ref) / ref for e in f32]
        print(json.dumps({
            "model": model, "E": errors,
            "float32_vs_float64_rel": f32_rel,
            "float32_vs_float64_rel_max": max(f32_rel),
            "float32_order_rel": abs(f32[0] - f32[1]) / ref,
            "float32_spread_rel": (max(f32) - min(f32)) / ref,
        }), flush=True)


if __name__ == "__main__":
    main()
