#!/usr/bin/env python3
"""How far float32 BA covariance blocks fall from float64, in the port and
in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/covariance_float32.py --sizes 20x400 100x1000 100x10000

For each VIEWSxPOINTS: the port's curved-tube scene (sigma = 0.005, a CPU
generator seeded with ``--seed``), the port's float64 dense BA from X and t
perturbed by 0.05 N(0, 1) (10 reference iterations, as chip_smoke's phase
4c), then at that state:

- the condition number of the undamped reduced camera system
  A = blockdiag(G) - F^T E^-1 F that the covariance inverts, and of its
  Jacobi-scaled form D A D (D = diag(A)^-1/2), in float64;
- the port's ``ba_covariance`` and ``ba_covariance_chunked`` (chunk 768)
  and the JAX package's ``ba_covariance``, each in float32, against the
  port's float64 ``ba_covariance``: the largest difference of the point
  and of the camera blocks over the largest float64 entry (NaN where the
  float32 Cholesky factor failed and the blocks are NaN).

Prints one JSON line per size.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", nargs="+", default=["20x400", "100x1000", "100x10000"])
    parser.add_argument("--seed", type=int, default=3)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    from mvrecon_tpu.models import covariance as jcov
    from mvrecon_tpu_torch.config import LMConfig
    from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu_torch.models import bundle_adjustment as tba
    from mvrecon_tpu_torch.models import covariance as tcov

    axis = "x-up_z-forward"

    def rel(got, want):
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want)
        return float(np.abs(got - want).max() / np.abs(want).max())

    for size in args.sizes:
        nf, npts = (int(v) for v in size.split("x"))
        sc = make_synthetic_scene(torch.Generator().manual_seed(args.seed), n_images=nf,
                                  n_slices=npts // 20, n_angles=20, dtype=torch.float64)
        rng = np.random.default_rng(args.seed)
        x = sc.x.transpose(0, 1).contiguous()
        X0 = sc.X + 0.05 * torch.from_numpy(rng.standard_normal(tuple(sc.X.shape)))
        t0 = sc.t + 0.05 * torch.from_numpy(rng.standard_normal(tuple(sc.t.shape)))
        ba = tba.bundle_adjust(x, X0, sc.K, sc.R, t0, axis=axis, device="cpu",
                               config=LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=10))
        state = (ba.X, ba.K, ba.R, ba.t)
        ref = tcov.ba_covariance(x, *state, axis=axis, device="cpu")

        xp, vis, st, free, _ = tba._prepare_problem(x, *state, 1.0, None, axis, "cpu")
        derivs, _ = tba._compute_derivs(st, xp, vis, free, 1.0)
        _, y = tcov._schur_terms(derivs.matE, derivs.matF)
        a = tba._reduced_camera_system(tcov._schur_product(derivs.matF, y), derivs.matG, free)
        del derivs, y
        d = torch.rsqrt(torch.diagonal(a))
        ev = torch.linalg.eigvalsh(a)
        ev_s = torch.linalg.eigvalsh(a * d[:, None] * d[None, :])

        x32 = x.float()
        s32 = [v.float() for v in state]
        rec = {"views": nf, "points": x.shape[0], "E_vs_noise_floor":
               float(ba.error) / (x.shape[0] * nf * 2 * 0.005**2),
               "cond_A": float(ev[-1] / ev[0]), "cond_DAD": float(ev_s[-1] / ev_s[0])}
        runs = {
            "port_dense": tcov.ba_covariance(x32, *s32, axis=axis, device="cpu"),
            "port_chunked": tcov.ba_covariance_chunked(x32, *s32, axis=axis, chunk_size=768,
                                                       device="cpu"),
            "jax_dense": jcov.ba_covariance(jnp.asarray(x32.numpy()),
                                            *(jnp.asarray(v.numpy()) for v in s32), axis=axis),
        }
        for name, cov in runs.items():
            rec[name] = {k: rel(getattr(cov, k), getattr(ref, k).numpy())
                         for k in ("point_cov", "camera_cov")}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
