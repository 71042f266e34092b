#!/usr/bin/env python3
"""How well the refit alternation recovers a distortion on the synthetic
curved-tube scene, with the port's dense core on the CPU.

The scene (cameras at radius 5 around a tube of radius about 0.5, f = 1)
sees its points at normalized radii |rho| below about 0.6, so s = |rho|^2
stays small and the quartic k2 s^2 trades against k1 s and the geometry at
an equal E. This script renders ``chip_smoke.py``'s shared truths (BAL
radial (-0.3, 0.05), OPENCV (-0.28, 0.035, 0.018, -0.012), and the four
of ``chip_smoke.FAMILY_TRUTHS``, as ``--models`` names them) into one
scene, runs ``bundle_adjust`` from ``default_distortion`` with the given
rounds and iterations (phase 4n's Nielsen settings, or phase 4p's
reference damping with ``--reference``) from X and t perturbed by
``--sigma`` N(0, 1), and prints one JSON line per model: the largest s, E
over the noise floor, the recovered k, its largest error against the
truth, and ``chip_smoke.model_error`` (the RMS error of the recovered
model's displacement over the true one's, on the scene's rays).

``--bal`` runs phase 4m's problem instead (each point seen by 20
consecutive views, 30 iterations a segment, ``delta_tol`` 1e-4), and
``--outliers`` adds its 2 % of the visible observations moved by
0.5 N(0, 1) under the Huber loss (delta 0.02); E is then over the
inliers.

Usage: python3 scripts/distortion_identifiability.py [--views 100]
       [--points 4000] [--rounds 2] [--iters 5] [--seed 0] [--reference]
       [--models radial,opencv] [--sigma 0.02] [--bal [--outliers]]
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
    parser.add_argument("--models", default="radial,opencv")
    parser.add_argument("--sigma", type=float, default=0.02)
    parser.add_argument("--bal", action="store_true", help="phase 4m's problem")
    parser.add_argument("--outliers", action="store_true", help="with --bal: 4m's outliers")
    args = parser.parse_args()
    damping = (dict(scale_factor=2.0) if args.reference else
               dict(scale_factor=4.0, accept_divisor=1.0, init_damping=3e-3, damping="nielsen"))
    scene = make_synthetic_scene(torch.Generator().manual_seed(args.seed), n_images=args.views,
                                 n_slices=args.points // 20, n_angles=20, dtype=torch.float32)
    truth = cs.true_state(tba, scene)
    start = cs.perturbed_cameras(scene, seed=31, sigma=args.sigma)
    npts = scene.X.shape[0]
    truths = {"radial": cs.RADIAL_TRUTH, "opencv": cs.OPENCV_TRUTH, **cs.FAMILY_TRUTHS}
    gen = torch.Generator().manual_seed(31)
    vis = keep = None
    if args.bal:  # 4m: each point seen by 20 consecutive views
        lo = (torch.randint(0, args.views, (npts,), generator=gen)
              - cs.BAL_WINDOW // 2).clamp(0, args.views - cs.BAL_WINDOW)
        cams = torch.arange(args.views)
        keep = (cams[None] >= lo[:, None]) & (cams[None] < lo[:, None] + cs.BAL_WINDOW)
        vis = keep.float()
        damping.update(delta_tol=1e-4, max_iter=30)
    for model in args.models.split(","):
        k = truths[model]
        dist = torch.tensor(k).expand(args.views, len(k))
        x = torch.empty((npts, args.views, 2))
        s_max = cs.render_all(torch, tba, truth, dist, gen, x, model=model)
        n_in = npts * args.views if keep is None else int(keep.sum())
        robust = {}
        inlier = keep
        if args.bal and args.outliers:
            seen = keep.flatten().nonzero()[:, 0]
            n_out = int(cs.BAL_OUTLIER_SHARE * seen.numel())
            pick = seen[torch.rand(seen.numel(), generator=gen).argsort()[:n_out]]
            x.view(-1, 2)[pick] += cs.BAL_OUTLIER_SCALE * torch.randn((n_out, 2), generator=gen)
            inlier = keep.clone()
            inlier.view(-1)[pick] = False
            n_in = int(inlier.sum())
            robust = dict(robust="huber", huber_delta=cs.HUBER_DELTA)
        fields = dict(dict(delta_tol=0.0, max_iter=args.iters), **damping, **robust)
        cfg = LMConfig(distortion_rounds=args.rounds, distortion_shared=True,
                       distortion_model=model, **fields)
        t0 = time.perf_counter()
        res = tba.bundle_adjust(x, *start, visibility=vis, axis="x-up_z-forward", config=cfg,
                                device="cpu")
        e = float(res.error)
        if inlier is not None:  # E over the inliers; unseen rays may sit on a pole
            f, u = tba.intrinsics_from_K(res.K, 1.0)
            st = tba.BAState(X=res.X, f=f, u=u, t=res.t, R=res.R)
            rp, rq = tba._residuals(st, x, inlier.float(), 1.0, res.distortion, model)
            e = float(torch.where(inlier, rp * rp + rq * rq, 0.0).sum())
        print(json.dumps({
            "model": model, "views": args.views, "points": npts, "rounds": args.rounds,
            "iters_per_segment": cfg.max_iter, "reference_damping": args.reference,
            "start_sigma": args.sigma, "bal": args.bal, "outliers": args.outliers,
            "s_max": s_max, "E_vs_noise_floor": e / (n_in * 2 * cs.NOISE**2),
            "k": res.distortion[0].tolist(), "k_true": list(k),
            "k_max_abs_err": cs.k_error(res, k),
            "model_rms_rel_err": cs.model_error(torch, tba, truth, res.distortion, dist,
                                                model=model),
            "cpu_wall_s": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
