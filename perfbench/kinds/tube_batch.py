"""Many small scenes: batches of tube scenes through
``batched_euclidean_reconstruction`` (self-calibration, then the dense LM
lanes) in blocks of ``scene_chunk``.

A unit is one whole batch. The judgement takes one batch of the window,
drawn from the seed, counts its scenes whose calibration failed
(``status_bad``, every scene), and compares a sample of its scenes, drawn
from the seed, with the plain reference: the E at each scene's state
(``e_eval_gap``), the E over the noise floor (``floor_ratio``, the
configuration's bound) and the least cost that the reference finds, by
float64 Levenberg-Marquardt steps from the answer and by its own solve
from the true scene (``e_opt_gap``, reported: the control does not
separate it); the worst scene counts.
"""

from __future__ import annotations

import torch

from .. import scenes
from ..reference import ba
from .base import CellBase


class Cell(CellBase):
    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from mvrecon_tpu_torch.config import LMConfig

        t = traffic
        base = scenes.batched_scenes(scenes.generator(t["problem_seed"], device), t["scenes"],
                                     t["views"], t["slices"], t["noise"])
        self.truth = scenes.permuted_scenes(base, scenes.order(seed, t["scenes"], device))
        self.x = self.truth.x  # (S, F, P, 2)
        cal = cfg["calibration"]
        self.kw = dict(config=LMConfig(**cfg["lm"], max_iter=t["max_iter"]), tol=cal["tol"],
                       method=cal["method"], eig_method=cal["eig_method"],
                       scene_chunk=t["scene_chunk"], device=device)

    def run(self, x):
        from mvrecon_tpu_torch.parallel.batched import batched_euclidean_reconstruction

        return batched_euclidean_reconstruction(x, timer=self.stages, **self.kw)

    def warm(self):
        self.run(self.x[:self.traffic["scene_chunk"]])

    def unit(self) -> int:
        res = self.run(self.x)
        self.answers.append((res.K, res.R, res.t, res.X, res.error, res.status))
        return self.x.shape[0]

    def problem(self, idx) -> ba.Problem:
        xy = self.x[idx].transpose(1, 2)  # (B, P, F, 2)
        B, P, F = xy.shape[:3]
        return ba.Problem(B, F, P, F, lambda dt: iter([ba.Chunk(0, P, xy.to(dt), None)]))

    def truth_start(self, idx, sigma: float = 0.0, gen=None):
        tr = self.truth
        B = len(idx)
        X = tr.X[None].expand(B, -1, -1)
        t = tr.t[idx]
        if sigma:
            X, t = scenes.perturbed(gen, X, sigma), scenes.perturbed(gen, t, sigma)
        return ba.Cams(tr.f[idx], torch.zeros_like(t[..., :2]), tr.R[idx], t), X

    def control_answer(self, idx):
        """The reference in the program's place for the scenes ``idx``, in
        float32 with TF32 products, from the true scenes with X and t
        moved by 0.02 N(0, 1): (K, R, t, X, reported E)."""
        j = self.traffic["judge"]
        cams, X = self.truth_start(idx, j["control_sigma"],
                                   scenes.generator(self.seed + 1, self.device))
        c, X, we, _ = ba.lm(self.problem(idx), cams, X, j["control_iters"], 1e-3, ba.TF32)
        K = torch.zeros(c.R.shape, dtype=c.R.dtype, device=c.R.device)
        K[..., 0, 0] = c.f
        K[..., 1, 1] = c.f
        K[..., :2, 2] = c.u
        K[..., 2, 2] = 1.0
        return K, c.R, c.t, X, we

    def sample(self, rng) -> list[int]:
        return sorted(rng.sample(range(self.x.shape[0]), self.traffic["judge"]["scenes"]))

    def judge(self, rng):
        pick = self.answers[rng.randrange(len(self.answers))]
        idx = self.sample(rng)
        status_bad = int(sum(int((a[5] != 0).sum()) for a in self.answers))
        return self.judge_scenes(idx, tuple(a[idx] for a in pick[:5]), status_bad)

    def judge_scenes(self, idx, answer, status_bad: int = 0):
        """The checks of the answer (K, R, t, X, E) of the scenes ``idx``."""
        j = self.traffic["judge"]
        K, R, t, X, e = answer
        pb = self.problem(idx)
        cams0, X0 = self.truth_start(idx)
        own = ba.lm(pb, cams0, X0, j["own_iters"], 1e-3)[3]
        cams = ba.Cams(K[..., 0, 0], K[..., :2, 2], R, t)
        r = ba.judge(pb, cams, X, e, j["polish"], best_cost=own)
        # the configuration's own bound: E over the noise floor 2 P F sigma^2
        P, F = pb.n_points, pb.n_cams
        r["floor_ratio"] = ba.costs(pb, cams, X)[0] / (2 * P * F * self.cfg["noise_sigma"] ** 2)
        readings = {k: v.max() for k, v in r.items()}
        readings["status_bad"] = status_bad
        out = self.limits(readings)
        bad = torch.zeros(len(idx), dtype=torch.bool, device=e.device)
        for k, v in r.items():
            if k in self.traffic["limits"]:
                bad |= ~(v <= self.traffic["limits"][k])
        self.failed = int(bad.sum()) + status_bad
        return out
