"""Plain bundle adjustment: the benchmark's reference for every cell.

Pinhole cameras with f0 = 1: an observation of point X by camera (f, u,
R, t) is predicted at f * (Xc_x, Xc_y) / Xc_z + u with Xc = R^T (X - t).
A camera has nine parameters (f, u0, u1, t, omega with R <- exp([omega]x)
R), a point three. The cost is sum rho(|r|) over the observations' 2-D
residuals r, rho(s) = s^2 (squared loss) or Huber's s^2 below delta and
2 delta s - delta^2 above it; the "weighted E" that the program reports
is sum w |r|^2 with the IRLS weight w = min(1, delta / |r|) at the same
state.

A problem is a batch of B independent problems of F cameras and P points
in which point p is seen by the W consecutive cameras lo[p] .. lo[p] + W -
1 (W = F, lo = 0 when every camera sees every point); its observations
come in point chunks (``Problem.chunks``), so a list of 500M observations
in host memory can be read a slab at a time.

Written from the equations above, independently of the program: analytic
derivatives (checked against autograd in the tests), Levenberg-Marquardt
with the Marquardt diagonal, the points eliminated by their 3x3 blocks
and the reduced camera system solved by a dense Cholesky factor. Nothing
of the program is imported. Every product goes through ``Prec.mm``, so the
control can run the same code with TF32 products (``Prec(float32,
tf32=True)``).
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    as the tensor cores round a TF32 product's inputs."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class Prec(NamedTuple):
    """The working precision: a dtype, and whether products take TF32
    inputs (the inputs rounded to TF32, the product summed in float32, as
    a TF32 tensor-core product does)."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            ops = tuple(round_tf32(o) for o in ops)
        return torch.einsum(eq, *ops)


F64 = Prec()
TF32 = Prec(torch.float32, True)


class Cams(NamedTuple):
    f: torch.Tensor  # (B, F)
    u: torch.Tensor  # (B, F, 2)
    R: torch.Tensor  # (B, F, 3, 3)
    t: torch.Tensor  # (B, F, 3)

    def to(self, dtype) -> "Cams":
        return Cams(*(a.to(dtype) for a in self))


class Chunk(NamedTuple):
    p0: int
    p1: int
    xy: torch.Tensor  # (B, Pc, W, 2)
    lo: torch.Tensor | None  # (B, Pc) first camera of each point; None: 0


class Problem(NamedTuple):
    """B problems of F cameras and P points, each point seen by W
    consecutive cameras. ``chunks(dtype)`` yields the observations a point
    chunk at a time on the device; ``delta`` is Huber's scale (None:
    squared loss)."""

    batch: int
    n_cams: int
    n_points: int
    window: int
    chunks: Callable[[torch.dtype], Iterator[Chunk]]
    delta: float | None = None

    @property
    def dense(self) -> bool:
        return self.window == self.n_cams


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _cam_index(pb: Problem, ch: Chunk) -> torch.Tensor:
    """(B, Pc, W) camera of each observation."""
    w = torch.arange(pb.window, device=ch.xy.device)
    if ch.lo is None:
        return w.expand(ch.xy.shape[:3])
    return ch.lo[..., None].long() + w


def _gather(a: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """a (B, F, ...) at the cameras ci (B, Pc, W) -> (B, Pc, W, ...)."""
    b = torch.arange(a.shape[0], device=a.device)[:, None, None]
    return a[b, ci]


def terms(pb: Problem, cams: Cams, X: torch.Tensor, ch: Chunk, prec: Prec, jac: bool):
    """The chunk's residuals r (B, Pc, W, 2) and, with ``jac``, the camera
    and point Jacobians Jc (B, Pc, W, 2, 9), Jp (B, Pc, W, 2, 3)."""
    dense = ch.lo is None
    ci = None if dense else _cam_index(pb, ch)
    R = cams.R[:, None] if dense else _gather(cams.R, ci)
    t = cams.t[:, None] if dense else _gather(cams.t, ci)
    f = cams.f[:, None] if dense else _gather(cams.f, ci)
    u = cams.u[:, None] if dense else _gather(cams.u, ci)
    d = X[:, ch.p0:ch.p1, None, :] - t  # (B, Pc, W, 3)
    xc = prec.mm("...ji,...j->...i", R, d)
    z = xc[..., 2:3]
    pi = xc[..., :2] / z
    r = f[..., None] * pi + u - ch.xy
    if not jac:
        return r, None, None
    # d res / d Xc = f / z [[1, 0, -pi_x], [0, 1, -pi_y]]
    fz = (f / z[..., 0])[..., None, None]
    a = torch.zeros(r.shape + (3,), dtype=r.dtype, device=r.device)
    a[..., 0, 0] = 1.0
    a[..., 1, 1] = 1.0
    a[..., :, 2] = -pi
    a = a * fz
    m = prec.mm("...kj,...ij->...ki", a, R)  # d res / d X = A R^T
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device).expand(r.shape + (2,))
    rot = torch.linalg.cross(m, d[..., None, :].expand_as(m), dim=-1)  # rows m_k x d
    jc = torch.cat([pi[..., None], eye2, -m, rot], dim=-1)
    return r, jc, m


def robust(pb: Problem, r: torch.Tensor):
    """(|r|^2, IRLS weight, rho) of each observation."""
    s2 = (r * r).sum(-1)
    if pb.delta is None:
        return s2, torch.ones_like(s2), s2
    s = torch.sqrt(s2)
    w = torch.clamp(pb.delta / torch.clamp_min(s, 1e-300 if s.dtype == torch.float64
                                                 else 1e-30), max=1.0)
    rho = torch.where(s <= pb.delta, s2, 2.0 * pb.delta * s - pb.delta ** 2)
    return s2, w, rho


def costs(pb: Problem, cams: Cams, X: torch.Tensor, prec: Prec = F64):
    """(weighted E, cost) of each of the B problems at (cams, X)."""
    cams, X = cams.to(prec.dtype), X.to(prec.dtype)
    we = torch.zeros(pb.batch, dtype=prec.dtype, device=X.device)
    cost = torch.zeros_like(we)
    for ch in pb.chunks(prec.dtype):
        r, _, _ = terms(pb, cams, X, ch, prec, False)
        s2, w, rho = robust(pb, r)
        we += (w * s2).sum((1, 2))
        cost += rho.sum((1, 2))
    return we, cost


def _point_system(pb: Problem, r, jc, jp, w, lam):
    """The chunk's damped point blocks' Cholesky factors L (B, Pc, 3, 3),
    point gradients gp (B, Pc, 3) and couplings Wm (B, Pc, W, 3, 9)."""
    wjp = jp * w[..., None, None]
    v = torch.einsum("bpwki,bpwkj->bpij", wjp, jp)
    gp = torch.einsum("bpwki,bpwk->bpi", wjp, r)
    wm = torch.einsum("bpwki,bpwkj->bpwij", wjp, jc)
    dv = torch.diagonal(v, dim1=-2, dim2=-1)
    v = v + torch.diag_embed(lam[:, None, None] * dv + 1e-12 * dv.mean(-1, keepdim=True))
    L, _ = torch.linalg.cholesky_ex(v)
    return L, gp, wm


def _apply(cams: Cams, dc: torch.Tensor) -> Cams:
    """cams + the (B, F, 9) step, R <- exp([omega]x) R."""
    return Cams(f=cams.f + dc[..., 0], u=cams.u + dc[..., 1:3],
                R=torch.linalg.matrix_exp(hat(dc[..., 6:9])) @ cams.R, t=cams.t + dc[..., 3:6])


def _gauge(cams: Cams) -> torch.Tensor:
    """(B, 9F) 1 at the seven parameters held fixed: camera 0's t and
    omega, and the component of camera 1's t along the larger of its
    offsets from camera 0."""
    B, F = cams.f.shape
    fixed = torch.zeros((B, 9 * F), dtype=cams.f.dtype, device=cams.f.device)
    fixed[:, 3:9] = 1.0
    ax = torch.argmax((cams.t[:, 1] - cams.t[:, 0]).abs(), dim=-1)
    fixed[torch.arange(B, device=fixed.device), 12 + ax] = 1.0
    return fixed


def lm_step(pb: Problem, cams: Cams, X: torch.Tensor, lam: torch.Tensor, prec: Prec):
    """One damped Gauss-Newton step for each of the B problems, damping
    ``lam`` (B,) times the diagonal: (cams', X', weighted E', cost')."""
    dev, dt = X.device, prec.dtype
    B, F, W = pb.batch, pb.n_cams, pb.window
    n9 = 9 * F
    U = torch.zeros((B, F, 9, 9), dtype=dt, device=dev)
    gc = torch.zeros((B, F, 9), dtype=dt, device=dev)
    S = torch.zeros((B, n9, n9), dtype=dt, device=dev)
    rc = torch.zeros((B, F, 9), dtype=dt, device=dev)
    if not pb.dense:
        n_lo = F - W + 1
        band = torch.zeros((B, n_lo, 9 * W, 9 * W), dtype=dt, device=dev)
    for ch in pb.chunks(dt):
        r, jc, jp = terms(pb, cams, X, ch, prec, True)
        _, w, _ = robust(pb, r)
        wjc = jc * w[..., None, None]
        L, gp, wm = _point_system(pb, r, jc, jp, w, lam)
        pc = wm.shape[1]
        y = torch.linalg.solve_triangular(L, wm.transpose(2, 3).reshape(B, pc, 3, 9 * W),
                                          upper=False)  # (B, Pc, 3, 9W)
        zp = torch.linalg.solve_triangular(L, gp[..., None], upper=False)[..., 0]
        if pb.dense:
            U += torch.einsum("bpwki,bpwkj->bwij", wjc, jc)
            gc += torch.einsum("bpwki,bpwk->bwi", wjc, r)
            y2 = y.reshape(B, 3 * pc, n9)
            S -= prec.mm("bki,bkj->bij", y2, y2)
            rc += prec.mm("bki,bk->bi", y2, zp.reshape(B, 3 * pc)).view(B, F, 9)
        else:
            ci = _cam_index(pb, ch).reshape(B, -1)
            flat = (torch.arange(B, device=dev)[:, None] * F + ci).reshape(-1)
            U.view(B * F, 9, 9).index_add_(
                0, flat, torch.einsum("bpwki,bpwkj->bpwij", wjc, jc).reshape(-1, 9, 9))
            gc.view(B * F, 9).index_add_(
                0, flat, torch.einsum("bpwki,bpwk->bpwi", wjc, r).reshape(-1, 9))
            rc.view(B * F, 9).index_add_(
                0, flat, prec.mm("bpki,bpk->bpi", y, zp).reshape(-1, 9))
            lo_flat = (torch.arange(B, device=dev)[:, None] * n_lo + ch.lo.long()).reshape(-1)
            for s in range(0, pc, 8192):
                ys = y[:, s:s + 8192]
                band.view(B * n_lo, 9 * W, 9 * W).index_add_(
                    0, lo_flat.view(B, pc)[:, s:s + 8192].reshape(-1),
                    prec.mm("bpki,bpkj->bpij", ys, ys).reshape(-1, 9 * W, 9 * W))
    if not pb.dense:
        i = torch.arange(9 * W, device=dev)
        lo9 = 9 * torch.arange(n_lo, device=dev)
        idx = ((lo9[:, None, None] + i[:, None]) * n9 + lo9[:, None, None] + i).reshape(-1)
        S.view(B, -1).index_add_(1, idx, -band.reshape(B, -1))
        del band
    du = torch.diagonal(U, dim1=-2, dim2=-1)
    U = U + torch.diag_embed(lam[:, None, None] * du + 1e-12 * du.mean((1, 2))[:, None, None])
    Sd = S.view(B, F, 9, F, 9).diagonal(dim1=1, dim2=3)  # (B, 9, 9, F)
    Sd += U.permute(0, 2, 3, 1)
    # the gauge: camera 0's t and omega and camera 1's largest t component
    # are held, so the system is regular
    fixed = _gauge(cams)
    keep = 1.0 - fixed
    S = S * keep[:, :, None] * keep[:, None, :] + torch.diag_embed(fixed)
    L, info = torch.linalg.cholesky_ex(S)
    rhs = ((rc - gc).reshape(B, n9) * keep)[..., None]
    dc = torch.cholesky_solve(rhs, L).view(B, F, 9)
    dc = torch.where((info == 0)[:, None, None], dc, torch.full_like(dc, float("nan")))
    del S, L
    new = _apply(cams, dc)
    X_new = X.clone()
    we = torch.zeros(B, dtype=dt, device=dev)
    cost = torch.zeros_like(we)
    for ch in pb.chunks(dt):
        r, jc, jp = terms(pb, cams, X, ch, prec, True)
        _, w, _ = robust(pb, r)
        L, gp, wm = _point_system(pb, r, jc, jp, w, lam)
        dcg = dc[:, None].expand(-1, wm.shape[1], -1, -1) if pb.dense else _gather(
            dc, _cam_index(pb, ch))
        g = gp + prec.mm("bpwij,bpwj->bpi", wm, dcg)
        X_new[:, ch.p0:ch.p1] = X[:, ch.p0:ch.p1] - torch.cholesky_solve(g[..., None], L)[..., 0]
        r2, _, _ = terms(pb, new, X_new, ch, prec, False)
        s2, w2, rho = robust(pb, r2)
        we += (w2 * s2).sum((1, 2))
        cost += rho.sum((1, 2))
    return new, X_new, we, cost


def lm(pb: Problem, cams: Cams, X: torch.Tensor, iters: int, lam0: float, prec: Prec = F64):
    """``iters`` Levenberg-Marquardt steps on each of the B problems, every
    one kept only where it lowers the cost (the damping divided by 10 on a
    kept step, multiplied by 10 on a rejected one). Returns (cams, X,
    weighted E, cost) at the end, in ``prec``."""
    cams, X = cams.to(prec.dtype), X.to(prec.dtype)
    we, cost = costs(pb, cams, X, prec)
    lam = torch.full((pb.batch,), lam0, dtype=prec.dtype, device=X.device)
    for _ in range(iters):
        c2, X2, we2, cost2 = lm_step(pb, cams, X, lam, prec)
        keep = torch.isfinite(cost2) & (cost2 < cost)
        k3 = keep[:, None, None]
        cams = Cams(torch.where(keep[:, None], c2.f, cams.f), torch.where(k3, c2.u, cams.u),
                    torch.where(k3[..., None], c2.R, cams.R), torch.where(k3, c2.t, cams.t))
        X = torch.where(k3, X2, X)
        we, cost = torch.where(keep, we2, we), torch.where(keep, cost2, cost)
        lam = torch.where(keep, lam / 10.0, lam * 10.0)
    return cams, X, we, cost


def judge(pb: Problem, cams: Cams, X: torch.Tensor, e_reported: torch.Tensor, polish: int,
          best_cost: torch.Tensor | None = None) -> dict:
    """The two readings of an answer (cams, X, reported E), per problem:

    - ``e_eval_gap``: |reported E - the weighted E at the answer's state| /
      the latter, the reference's E in float64;
    - ``e_opt_gap``: (cost at the answer - the least cost found) / the
      least, where the least is over the answer, ``polish`` float64 LM
      steps of the reference from it, and ``best_cost`` (the reference's
      own solve, where the caller has one)."""
    we, cost = costs(pb, cams, X)
    e_rep = e_reported.to(torch.float64)
    out = {"e_eval_gap": (e_rep - we).abs() / we}
    best = cost
    if polish:
        best = torch.minimum(best, lm(pb, cams, X, polish, 1e-6)[3])
    if best_cost is not None:
        best = torch.minimum(best, best_cost.to(best.dtype))
    out["e_opt_gap"] = (cost - best) / best
    # a non-finite answer fails every number
    bad = ~(torch.isfinite(e_rep) & torch.isfinite(we) & torch.isfinite(cost))
    return {k: torch.where(bad, float("inf"), v) for k, v in out.items()}
