#!/usr/bin/env python3
"""How often the affine pipeline reaches the noise floor, in the JAX
package and in the port, on the same scenes (CPU, float64).

    JAX_PLATFORMS=cpu python scripts/affine_branch_survey.py --seeds 32 --batched-seeds 128

For each of ``--seeds`` seeds: the JAX package's scene (12 views x 200
points, the reference affine demo's shape), JAX's
``affine_reconstruction`` with its backend's SVD signs and with
``canonical_signs`` (the convention of its point-sharded path and of the
port's pipeline), and the port's ``affine_reconstruction``;
paraperspective, f = 1, ``LMConfig(scale_factor=2, delta_tol=1e-8,
max_iter=50)``. Prints one JSON line per seed with E / noise floor and BA
iterations, and a summary line with the count of scenes above 1.5x the
floor on each path. Then the port's ``batched_affine_reconstruction`` on
the scenes of ``--batched-seeds`` seeds at once: the count above 1.5x, the
worst and the median E / floor.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=16)
    parser.add_argument("--batched-seeds", type=int, default=128)
    parser.add_argument("--max-iter", type=int, default=50)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from mvrecon_tpu.config import LMConfig as JLMConfig
    from mvrecon_tpu.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu.models import affine as jaff
    from mvrecon_tpu.models import pipelines as jpipe
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.models.pipelines import affine_reconstruction
    from mvrecon_tpu_torch.parallel.batched import batched_affine_reconstruction

    fields = dict(scale_factor=2.0, delta_tol=1e-8, max_iter=args.max_iter)
    backend_cal = jpipe.affine_self_calibration
    canonical_cal = functools.partial(jaff.affine_self_calibration, canonical_signs=True)
    above = {"jax_backend_signs": 0, "jax_canonical_signs": 0, "port": 0}
    for seed in range(args.seeds):
        sc = make_synthetic_scene(jax.random.key(seed), n_images=12, dtype=jnp.float64)
        x, f = np.array(sc.x), np.ones(12)
        floor = x.shape[0] * x.shape[1] * 2 * 0.005**2
        rec = {"seed": seed}
        for name, cal in (("jax_backend_signs", backend_cal),
                          ("jax_canonical_signs", canonical_cal)):
            jpipe.affine_self_calibration = cal
            r = jpipe.affine_reconstruction(jnp.asarray(x), jnp.asarray(f),
                                            config=JLMConfig(**fields))
            rec[name] = [float(r.error) / floor, int(r.n_iter)]
        jpipe.affine_self_calibration = backend_cal
        r = affine_reconstruction(x, f, config=LMConfig(**fields), device="cpu")
        rec["port"] = [float(r.error) / floor, r.n_iter]
        for name in above:
            above[name] += rec[name][0] > 1.5
        print(json.dumps(rec), flush=True)
    print(json.dumps({"scenes": args.seeds, "above_1.5x_floor": above}))

    scene = jax.jit(make_synthetic_scene, static_argnames=("n_images", "dtype"))
    x = np.stack([np.array(scene(jax.random.key(s), n_images=12, dtype=jnp.float64).x)
                  for s in range(args.batched_seeds)])
    r = batched_affine_reconstruction(x, np.ones(x.shape[:2]), config=LMConfig(**fields),
                                      device="cpu")
    ratio = (r.error / (x.shape[2] * 12 * 2 * 0.005**2)).numpy()
    print(json.dumps({"port_batched_scenes": len(ratio),
                      "above_1.5x_floor": int((ratio > 1.5).sum()),
                      "worst_E_vs_noise_floor": float(ratio.max()),
                      "median_E_vs_noise_floor": float(np.median(ratio))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
