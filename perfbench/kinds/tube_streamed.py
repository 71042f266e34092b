"""Observations that outgrow the card: back-to-back solves of
``bundle_adjust_streamed`` whose (P, F, 2) observations stay in host
memory and stream to the card a point chunk at a time (the pinned feed,
pass 1 through the K1 kernel, pass 2).

A unit is one whole solve. The judgement takes one solve of the window,
drawn from the seed, and compares it with the plain reference, which
streams the same host array: the E at its state (``e_eval_gap``) and
the cost that float64 Levenberg-Marquardt steps from it find
(``e_opt_gap``). The control is the reference in the program's place with
TF32 products.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import scenes
from ..reference import ba
from .base import CellBase
from .sparse_bal import intrinsics


class Cell(CellBase):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mvrecon_tpu_torch.config import LMConfig

        t = traffic
        self.x_host, _, self.start = scenes.streamed_problem(
            scenes.generator(t["problem_seed"], device), t["views"], t["points"], t["noise"],
            t["start_sigma"], seed)
        self.K = intrinsics(self.start[1])
        self.config = LMConfig(**cfg["lm_streamed"], max_iter=t["max_iter"])
        self.kw = dict(axis=cfg["gauge_axis"], chunk_size=cfg["chunk"],
                       prefetch=cfg["prefetch"], device=device)
        self.n_points, self.n_cams = self.x_host.shape[:2]

    def solve(self, config):
        from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed

        X0, _, R, t0 = self.start
        return bundle_adjust_streamed(self.x_host, X0, self.K, R, t0, config=config,
                                      timer=self.spans, **self.kw)

    def warm(self):
        self.solve(dataclasses.replace(self.config, max_iter=1))

    def instrument(self, run):
        """Spans of the core's passes and of every K1 call, with its shape."""
        super().instrument(run)
        import mvrecon_tpu_torch.ops.syrk as syrk_mod

        inner = syrk_mod.syrk_lower
        spans = self.spans

        def timed(y):
            k_rows, n = y.shape
            with spans.span("syrk_lower"):
                out = inner(y)
            self.shapes.setdefault("syrk_lower", []).append((k_rows, n))
            return out

        syrk_mod.syrk_lower = timed

    def unit(self) -> int:
        res = self.solve(self.config)
        self.answers.append((res.K, res.R, res.t, res.X, res.error))
        self.count("retries", res.log["n_solver_retries"])
        return 1

    def problem(self) -> ba.Problem:
        P, F = self.n_points, self.n_cams
        step = self.traffic["judge"]["points_per_chunk"]

        def chunks(dtype):
            for p0 in range(0, P, step):
                p1 = min(p0 + step, P)
                xy = torch.from_numpy(np.ascontiguousarray(self.x_host[p0:p1]))
                yield ba.Chunk(p0, p1, xy.to(self.device).to(dtype)[None], None)

        return ba.Problem(1, F, P, F, chunks)

    def control_answer(self):
        X0, f, R, t0 = self.start
        cams = ba.Cams(f[None], torch.zeros_like(t0[None, :, :2]), R[None], t0[None])
        c, X, we, _ = ba.lm(self.problem(), cams, X0[None], self.traffic["judge"]["control_iters"],
                            1e-3, ba.TF32)
        K = intrinsics(c.f[0])
        K[..., :2, 2] = c.u[0]
        return K, c.R[0], c.t[0], X[0], we[0]

    def judge(self, rng, answer=None):
        """The checks of one answer (K, R, t, X, E): the given one, or one
        of the window's drawn by ``rng``."""
        K, R, t, X, e = answer or self.answers[rng.randrange(len(self.answers))]
        cams = ba.Cams(K[None, :, 0, 0], K[None, :, :2, 2], R[None], t[None])
        r = ba.judge(self.problem(), cams, X[None], e.reshape(1),
                     self.traffic["judge"]["polish"])
        out = self.limits({k: v[0] for k, v in r.items()})
        self.failed = int(any(c["value"] > c["limit"] for c in out.values()))
        return out
