"""BAL-class bundle adjustment on the observation list: back-to-back
solves of ``bundle_adjust_sparse``, each from its problem's start.

The traffic fixes a few problems (``problem_seeds``). A solve's CG and
retry counts follow the order of its sums, so a reordering of one
problem's points is another amount of work; every seed therefore solves
the same problems, one whole solve of each a unit, in an order that
``--seed`` draws. The judgement takes one solve of the window, drawn from
the seed, and compares its state and reported E with the
plain reference: the weighted E at its state (``e_eval_gap``) and the
Huber cost that float64 Levenberg-Marquardt steps of the reference find
from it (``e_opt_gap``). The control is the reference in the program's
place with TF32 products (``control_answer``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import scenes
from ..reference import ba
from .base import CellBase


def intrinsics(f: torch.Tensor) -> torch.Tensor:
    k = torch.zeros(f.shape + (3, 3), dtype=f.dtype, device=f.device)
    k[..., 0, 0] = f
    k[..., 1, 1] = f
    k[..., 2, 2] = 1.0
    return k


class Bal(NamedTuple):
    lst: scenes.WindowList
    start: tuple
    obs: object  # the program's SparseObs
    K: torch.Tensor


class Cell(CellBase):
    """A unit is one solve of each of the traffic's problems, in an order
    that ``--seed`` draws."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mvrecon_tpu_torch.config import LMConfig

        self.problems = [self.draw(ps) for ps in traffic["problem_seeds"]]
        self.order = scenes.order(seed, len(self.problems), "cpu").tolist()
        self.kw = dict(axis=cfg["gauge_axis"], config=LMConfig(**cfg["lm"]),
                       cg_tol=cfg["cg_tol"], cg_max_iter=cfg["cg_max_iter"],
                       factor_mode=cfg["factor_mode"], device=device)
        pb = self.problems[0]
        self.n_obs, self.n_points, self.n_cams = (pb.lst.point_idx.shape[0], pb.start[0].shape[0],
                                                  pb.K.shape[0])

    def draw(self, problem_seed: int) -> Bal:
        from mvrecon_tpu_torch.models.bundle_adjustment_sparse import SparseObs

        t = self.traffic
        lst, _, start = scenes.bal_class_problem(
            scenes.generator(problem_seed, self.device), t["cameras"], t["points"], t["window"],
            t["noise"], t["outlier_share"], t["outlier_sigma"], t["start_sigma"])
        n = lst.point_idx.shape[0]
        obs = SparseObs(lst.point_idx, lst.cam_idx, lst.xy, torch.ones(n, device=self.device))
        return Bal(lst, start, obs, intrinsics(start[1]))

    def solve(self, i: int):
        from mvrecon_tpu_torch.models.bundle_adjustment_sparse import bundle_adjust_sparse

        pb = self.problems[i]
        X0, _, R, t0 = pb.start
        return bundle_adjust_sparse(pb.obs, X0, pb.K, R, t0, timer=self.spans, **self.kw)

    def warm(self):
        self.solve(self.order[0])

    def unit(self) -> int:
        for i in self.order:
            res = self.solve(i)
            self.answers.append((i, res.K, res.R, res.t, res.X, res.error))
            self.count("retries", res.log["n_solver_retries"])
            self.count("cg_iters", res.log["cg_iters_total"])
        return len(self.order)

    def problem(self, i: int) -> ba.Problem:
        lst = self.problems[i].lst
        P, W = self.n_points, lst.window
        xy = lst.xy.view(2, P, W)
        step = self.traffic["judge"]["points_per_chunk"]

        def chunks(dtype):
            for p0 in range(0, P, step):
                p1 = min(p0 + step, P)
                yield ba.Chunk(p0, p1, xy[:, p0:p1].permute(1, 2, 0)[None].to(dtype),
                               lst.lo[None, p0:p1])

        return ba.Problem(1, self.n_cams, P, W, chunks, self.cfg["lm"]["huber_delta"])

    def control_answer(self, i: int | None = None):
        """The reference from problem ``i``'s start (the seed's first), in
        float32 with TF32 products, in the program's place: (i, K, R, t, X,
        reported E)."""
        i = self.order[0] if i is None else i
        X0, f, R, t0 = self.problems[i].start
        cams = ba.Cams(f[None], torch.zeros_like(t0[None, :, :2]), R[None], t0[None])
        c, X, we, _ = ba.lm(self.problem(i), cams, X0[None],
                            self.traffic["judge"]["control_iters"], 1e-3, ba.TF32)
        K = intrinsics(c.f[0])
        K[..., :2, 2] = c.u[0]
        return i, K, c.R[0], c.t[0], X[0], we[0]

    def judge(self, rng, answer=None):
        """The checks of one answer (problem, K, R, t, X, E): the given one,
        or one of the window's solves drawn by ``rng``."""
        i, K, R, t, X, e = answer or self.answers[rng.randrange(len(self.answers))]
        cams = ba.Cams(K[None, :, 0, 0], K[None, :, :2, 2], R[None], t[None])
        r = ba.judge(self.problem(i), cams, X[None], e.reshape(1),
                     self.traffic["judge"]["polish"])
        out = self.limits({k: v[0] for k, v in r.items()})
        self.failed = int(any(c["value"] > c["limit"] for c in out.values()))
        return out
