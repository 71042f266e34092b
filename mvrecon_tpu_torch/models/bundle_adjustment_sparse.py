"""Sparse observation-list bundle adjustment, O(n_obs) memory.

Counterpart of ``mvrecon_tpu/models/bundle_adjustment_sparse.py``. Every
other core keeps a dense (P, F) mask over (P, F, 2) observations; at 1M
points x 1,600 cameras that is 12.8 GB of float32 before any work. Here
the problem is a flat observation list sorted by point id
(:class:`SparseObs`: ``point_idx``, ``cam_idx``, ``xy`` (2, N),
``weights``), which is what BAL-class problems at 0.1-1 % fill need.

Design, for the card:

- **Layout.** Every per-observation quantity is a (k, N) tensor, one row
  per component (structure of arrays): a kernel over N reads each row
  coalesced. The Jacobian factors are one (24, N) tensor (a1, a2 (3, N);
  b1, b2 (9, N)); per-point quantities are (3, P) rows, the symmetric 3x3
  point blocks six (6, P) rows in the order (00, 11, 22, 01, 02, 12).
  Camera parameters are gathered per observation from one stacked (k, F)
  table by a single ``index_select``; the table is small and stays in
  cache.
- **Indices.** ``point_idx`` and ``cam_idx`` are int32 on the device:
  ``index_select`` takes int32 indices on the card and the CPU without a
  copy. The segment offsets and permutations that the reductions use are
  int64, as ``sort`` and ``searchsorted`` return them.
- **Per-observation work is the virtual-camera trick**: the list is one
  point seen by N "cameras" whose parameters are gathered per observation,
  so the dense core's distortion chain (all six families,
  ``_apply_distortion_chain``), robust weights and refit terms apply
  unchanged to (1, C) views.
- **Reductions are sorted segment sums, deterministic.** A pass runs over
  chunks of the observation list (:class:`_Chunk`), planned once per
  problem on the device: the point range of the chunk with its segment
  offsets (the list is sorted by point, so these are contiguous), and a
  stable camera sort of the chunk with its camera offsets. Point sums are
  ``segment_reduce`` over the point offsets; camera sums gather the chunk's
  rows into camera order and reduce those segments. A segment is summed
  in a fixed order, so E, the CG counts and the retries repeat exactly
  from run to run (float atomics, as in ``index_add_`` on the card, would
  not). Short segments are reduced by one call over all rows; long ones
  (a camera's share of the whole list) row by row, where the card's
  segmented reduction gives each segment a block of threads.
- **Camera side.** The reduced camera system is never formed. The damped
  Schur complement S = G^ - F^T E^-1 F is applied matrix-free (each
  matvec: a gather of the camera vector, rowwise dots, a point segment
  sum, a 3x3 solve per point, a gather of the point vector, rowwise dots,
  a camera segment sum), preconditioned by the true 9x9 diagonal blocks
  of S (SCHUR_JACOBI, through ``inv9_spd``), and solved by PCG. The PCG
  loop reads its convergence flag on the host every ``_CG_CHECK``
  iterations; a converged iteration takes a zero step and is not counted,
  so x and the count equal those of a loop that stops at once.
- **LM protocol** as the dense and chunked cores: Nielsen or reference
  damping with the c <= 1e25 / nu <= 1e12 clamps, the warm start of a
  retried solve from the rejected step, the IRLS base error, one host
  read per retry. One deviation: a retry starts cold when the rejected
  step is not finite. In float32 at small damping a preconditioner block
  can fail its Cholesky and make the step NaN; warm-started from it, the
  JAX package's loop rejects every later retry and stops where it stands.

Memory: with ``factor_mode="stored"`` the 24 factor rows stay resident
across a retry (0.96 GB in float32 at 10M observations; ``factor_dtype=
"bfloat16"`` halves them, and every product upcasts first). The build's
camera blocks and the distortion chain run in chunks of ``obs_chunk``
observations; ``matvec_chunk`` chunks the CG matvec's transients too.
``factor_mode="recompute"`` stores no factor rows: every pass recomputes
them chunk by chunk from the O(P + F) state.

Point sharding (``parallel/sharded_ba_sparse.py``): with ``axis_name``
each rank holds the observations of a contiguous range of points and those
points, and the cameras are replicated. Everything point-side stays on the
rank; the camera-side sums are all-reduced through ``_psum`` where the JAX
package psums them: E (the start, the build's weighted E, every trial), the
build's camera rows (d_F, the rhs sums, the camera blocks, the
preconditioner correction and the seen-camera weights, one (109, F)
all-reduce a retry), the matvec's camera sums (one (9, F) all-reduce a CG
iteration), Nielsen's two point-side sums (one all-reduce of two values a
retry) and the refit's normal terms. Every host read (PCG's flag, the
retry's acceptance) reads those replicated values only, so the ranks take
the same branches.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import LMConfig, as_tensor, resolve_device
from ..ops.linalg import inv9_spd
from ..runtime.profiling import span
from .bundle_adjustment import (
    BAResult,
    BAState,
    _apply_distortion_chain,
    _apply_update,
    _check_config,
    _distorted_residual,
    _lm_damping,
    _psum,
    _refit_rounds,
    _refit_solve,
    _refit_terms,
    build_K,
    default_distortion,
    distortion_nterms,
    gauge_mask,
    intrinsics_from_K,
    normalize_gauge,
    resolve_distortion_model,
    resolve_robust,
    restore_gauge,
    robust_weight,
)

_CG_CHECK = 4  # PCG iterations between host reads of the convergence flag
_LONG_SEGMENT = 512  # mean segment length above which rows reduce one by one
_SYM3 = (0, 3, 4, 3, 1, 5, 4, 5, 2)  # six symmetric rows -> the 3x3 by rows
_E6 = ((0, 1, 2, 0, 0, 1), (0, 1, 2, 1, 2, 2))  # (i, j) of the six rows
_T9 = tuple(torch.triu_indices(9, 9).tolist())  # (i, j) of the 45 upper entries


class SparseObs(NamedTuple):
    """Observation list sorted ascending by ``point_idx``. ``xy`` is (2, N);
    ``weights`` are per-observation confidences (multiplied into the IRLS
    weights), 0 for padding."""

    point_idx: torch.Tensor  # (N,) int32, sorted ascending
    cam_idx: torch.Tensor  # (N,) int32
    xy: torch.Tensor  # (2, N)
    weights: torch.Tensor  # (N,)

    @property
    def n_obs(self) -> int:
        return self.point_idx.shape[0]

    def to(self, device, dtype=None) -> "SparseObs":
        """The list on ``device``, ``xy`` and ``weights`` in ``dtype``."""
        dt = self.xy.dtype if dtype is None else dtype
        return SparseObs(self.point_idx.to(device), self.cam_idx.to(device),
                         self.xy.to(device, dt), self.weights.to(device, dt))


def make_sparse_obs(point_idx, cam_idx, xy, weights=None, device=None) -> SparseObs:
    """Host-side constructor from numpy arrays: a stable sort by point id
    (each point keeps its camera order), shape checks, ``xy`` stored (2, N).
    Accepts ``xy`` as (N, 2) or already (2, N); the dtype is xy's. The list
    goes to the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    point_idx = np.asarray(point_idx)
    cam_idx = np.asarray(cam_idx)
    xy = np.asarray(xy)
    n = point_idx.shape[0] if point_idx.ndim else 0
    if xy.shape == (2, n) and n != 2:
        xy = np.ascontiguousarray(xy.T)
    if not (point_idx.shape == cam_idx.shape == xy.shape[:-1]) or xy.shape[-1] != 2:
        raise ValueError(f"inconsistent observation shapes: {point_idx.shape}, "
                         f"{cam_idx.shape}, {xy.shape}")
    w = np.ones(point_idx.shape, xy.dtype) if weights is None else np.asarray(weights, xy.dtype)
    order = np.argsort(point_idx, kind="stable")
    return SparseObs(
        point_idx=torch.from_numpy(point_idx[order].astype(np.int32)).to(dev),
        cam_idx=torch.from_numpy(cam_idx[order].astype(np.int32)).to(dev),
        xy=torch.from_numpy(np.ascontiguousarray(xy[order].T)).to(dev),
        weights=torch.from_numpy(np.ascontiguousarray(w[order])).to(dev),
    )


def dense_to_sparse_obs(x, visibility, device=None) -> SparseObs:
    """(P, F, 2) dense observations and a (P, F) mask -> the observation
    list (point-major order is sorted); the mask's values become the
    weights."""
    x = np.asarray(x)
    vis = np.asarray(visibility)
    pi, ci = np.nonzero(vis > 0)
    return make_sparse_obs(pi, ci, x[pi, ci], vis[pi, ci].astype(x.dtype), device)


# --------------------------------------------------------------------------
# the chunk plan and the segment sums
# --------------------------------------------------------------------------


class _Chunk(NamedTuple):
    """One contiguous slice [start, end) of the observation list, with what
    its reductions need: the points it covers, [p_lo, p_hi), with their
    segment offsets in the slice, and the slice's stable camera sort
    (local indices) with the F + 1 camera offsets in that order."""

    start: int
    end: int
    p_lo: int
    p_hi: int
    p_off: torch.Tensor
    c_perm: torch.Tensor
    c_off: torch.Tensor


def _plan(obs: SparseObs, nf: int, chunk: int) -> tuple[_Chunk, ...]:
    """The chunks of ``chunk`` observations (the last one shorter). One
    host read fetches every chunk's point range."""
    n = obs.n_obs
    pi, ci = obs.point_idx, obs.cam_idx
    starts = list(range(0, n, max(chunk, 1)))
    ends = starts[1:] + [n]
    bounds = torch.stack([pi[starts], pi[[e - 1 for e in ends]]]).tolist()
    cams = torch.arange(nf + 1, dtype=ci.dtype, device=ci.device)
    out = []
    for s, e, lo, hi in zip(starts, ends, *bounds):
        pi_c = pi[s:e]
        c_sorted, c_perm = torch.sort(ci[s:e], stable=True)
        out.append(_Chunk(
            s, e, lo, hi + 1,
            torch.searchsorted(pi_c, torch.arange(lo, hi + 2, dtype=pi.dtype, device=pi.device)),
            c_perm, torch.searchsorted(c_sorted, cams)))
    return tuple(out)


def _cached_plan(plans: dict, obs: SparseObs, nf: int, chunk: int) -> tuple[_Chunk, ...]:
    """``_plan`` of ``chunk`` (at most the list's length), kept in ``plans``
    so that the refits and LM segments of one solve plan each size once."""
    chunk = min(chunk, max(obs.n_obs, 1))
    if chunk not in plans:
        plans[chunk] = _plan(obs, nf, chunk)
    return plans[chunk]


def _seg_sum(rows: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """(k, C) rows, sorted into segments by ``off`` (n + 1,) -> (k, n) sums.
    Each segment is summed in a fixed order (deterministic). Long segments
    are reduced row by row: a 1-D ``segment_reduce`` on the card gives each
    segment a block of threads, the k-row form one thread."""
    k, c = rows.shape
    n = off.shape[0] - 1
    if c > _LONG_SEGMENT * n:
        return torch.stack([torch.segment_reduce(r, "sum", offsets=off) for r in rows])
    return torch.segment_reduce(rows, "sum", offsets=off.expand(k, n + 1), axis=1)


def _pt_add(acc: torch.Tensor, rows: torch.Tensor, ch: _Chunk) -> None:
    """acc (k, P) += the point sums of a chunk's rows (k, C), in point order."""
    acc[:, ch.p_lo:ch.p_hi] += _seg_sum(rows, ch.p_off)


def _cam_sum(rows: torch.Tensor, ch: _Chunk) -> torch.Tensor:
    """(k, C) rows of a chunk in point order -> (k, F) camera sums."""
    return _seg_sum(rows.index_select(1, ch.c_perm), ch.c_off)


def _sym3_inv(e: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of symmetric 3x3 blocks held as (6, M) rows."""
    a, d, f, b, c, ee = e
    adj = torch.stack([d * f - ee * ee, a * f - c * c, a * d - b * b,
                       c * ee - b * f, b * ee - c * d, b * c - a * ee])
    det = a * adj[0] + b * adj[3] + c * adj[4]
    return adj * (1.0 / det)


def _sym3_matvec(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(6, M) symmetric rows times (3, M) vectors -> (3, M)."""
    return (e[list(_SYM3)].view(3, 3, -1) * v[None]).sum(1)


def _sym45_to_blocks(rows: torch.Tensor) -> torch.Tensor:
    """(45, F) upper-triangle rows -> (F, 9, 9) symmetric blocks."""
    m = rows.new_zeros((rows.shape[1], 9, 9))
    m[:, _T9[0], _T9[1]] = rows.T
    m[:, _T9[1], _T9[0]] = rows.T
    return m


# --------------------------------------------------------------------------
# per-observation factors (the virtual-camera trick)
# --------------------------------------------------------------------------

# rows of the per-camera table: 12 camera-matrix entries by rows, f, u (2),
# then the distortion's nd columns; the residual passes gather these. The
# derivative passes gather the three columns of R (3 each) and t after them.
_PM, _F, _U, _NRES = slice(0, 12), 12, slice(13, 15), 15


def _calc_pmat(cam: BAState, f0: float) -> torch.Tensor:
    """(F, 3, 4) camera matrices K [R^T | -R^T t]."""
    rt = cam.R.transpose(-1, -2)
    trans = -torch.einsum("fij,fj->fi", rt, cam.t)
    return build_K(cam.f, cam.u, f0) @ torch.cat([rt, trans[..., None]], dim=-1)


def _cam_table(cam: BAState, f0: float, dist=None, geometry: bool = True) -> torch.Tensor:
    """(15 + nd [+ 12], F) stacked camera rows, gathered per observation by
    one ``index_select``: the residual rows, then with ``geometry`` the
    rotation columns and t that the derivatives need."""
    nf = cam.f.shape[0]
    parts = [_calc_pmat(cam, f0).reshape(nf, 12), cam.f[:, None], cam.u]
    if dist is not None:
        parts.append(dist)
    if geometry:
        parts += [cam.R[:, :, 0], cam.R[:, :, 1], cam.R[:, :, 2], cam.t]
    return torch.cat(parts, dim=1).T.contiguous()


def _chain_state(f_g: torch.Tensor, u_g: torch.Tensor) -> BAState:
    """Per-observation virtual-camera state for the distortion chain, which
    reads only f and u."""
    z = f_g.new_zeros(())
    return BAState(X=z, f=f_g, u=u_g, t=z, R=z)


def _pqr(g: torch.Tensor, X_g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(3, C) homogeneous (p, q, r) from gathered camera rows and points;
    r = 1 where the weight is 0 (padding: no 0 * inf)."""
    pm = g[_PM].view(3, 4, -1)
    pqr = (pm[:, :3] * X_g[None]).sum(1) + pm[:, 3]
    pqr[2] = torch.where(w > 0, pqr[2], torch.ones_like(pqr[2]))
    return pqr


def _residual_cols(rtab, X_t, pi, ci, xy, w, f0: float, model=None):
    """(res_p, res_q) of a slice of the list from a residual table
    (``geometry=False``); through the distortion when it has its rows."""
    g = rtab.index_select(1, ci)
    p, q, r = _pqr(g, X_t.index_select(1, pi), w)
    if g.shape[0] == _NRES:
        return p / r - xy[0] / f0, q / r - xy[1] / f0
    rp, rq = _distorted_residual(_chain_state(g[_F], g[_U].T), p[None], q[None], r[None],
                                 xy.T[None], f0, g[_NRES:].T, model)
    return rp[0], rq[0]


def _factor_cols(tab, X_t, pi, ci, xy, w, f0: float, huber_delta=None, model=None,
                 robust_kind: str = "huber"):
    """Residuals and rank-2 Jacobian factors of a slice of the list: the
    dense core's derivative formulas per observation, through the
    distortion chain when ``tab`` carries its rows. Returns (a1, a2 (3, C),
    b1, b2 (9, C), res (2, C), w (C,)) with w the effective weight (the
    input weight times the IRLS weight with ``huber_delta``). Elementwise
    and gathers only, so any slicing of the list gives the same values."""
    g = tab.index_select(1, ci)
    X_g = X_t.index_select(1, pi)
    pqr = _pqr(g, X_g, w)
    p, q, r = pqr
    pm = g[_PM].view(3, 4, -1)
    nd = g.shape[0] - _NRES - 12
    f_g, u_g = g[_F], g[_U]
    rc = g[_NRES + nd:_NRES + nd + 9].view(3, 3, -1)  # the columns of R
    t_g = g[_NRES + nd + 9:]
    res_p = p / r - xy[0] / f0
    res_q = q / r - xy[1] / f0
    inv_r2 = 1.0 / (r * r)
    # point rows: d(p, q, r)/dX are the camera-matrix rows
    a = (r * pm[:2, :3] - pqr[:2, None] * pm[2, :3]) * inv_r2  # (2, 3, C)
    # camera rows in the order (f, u0, u1, t, omega)
    zeros = torch.zeros_like(r)
    r_f0 = r / f0
    dpdt = -(f_g * rc[0] + u_g[0] * rc[2])
    dqdt = -(f_g * rc[1] + u_g[1] * rc[2])
    drdt = -f0 * rc[2]
    x_m_t = X_g - t_g
    d = torch.stack([
        torch.cat([torch.stack([(p - (u_g[0] / f0) * r) / f_g, r_f0, zeros]), dpdt,
                   torch.linalg.cross(-dpdt, x_m_t, dim=0)]),
        torch.cat([torch.stack([(q - (u_g[1] / f0) * r) / f_g, zeros, r_f0]), dqdt,
                   torch.linalg.cross(-dqdt, x_m_t, dim=0)]),
        torch.cat([zeros.expand(3, -1), drdt, torch.linalg.cross(-drdt, x_m_t, dim=0)]),
    ])  # (3, 9, C): d(p, q, r)
    b = (r * d[:2] - pqr[:2, None] * d[2]) * inv_r2  # (2, 9, C)
    a1, a2, b1, b2 = a[0], a[1], b[0], b[1]
    if nd:
        res_p, res_q, a1, a2, b1, b2 = _apply_distortion_chain(
            _chain_state(f_g, u_g.T), p[None], q[None], r[None], f0, g[_NRES:_NRES + nd].T,
            res_p[None], res_q[None], a1.T[None], a2.T[None], b1.T[None], b2.T[None], model)
        res_p, res_q = res_p[0], res_q[0]
        a1, a2, b1, b2 = (m[0].T for m in (a1, a2, b1, b2))
    if huber_delta is not None:
        w = w * robust_weight(torch.sqrt(res_p**2 + res_q**2), huber_delta, robust_kind)
    return a1, a2, b1, b2, torch.stack([res_p, res_q]), w


# --------------------------------------------------------------------------
# the solver context: one retry's factors, point blocks and camera blocks
# --------------------------------------------------------------------------


class _Problem(NamedTuple):
    """What every pass of one LM solve reads: the observation list, the
    chunk plans (``full``: one chunk over the list; ``obs``: chunks of
    ``obs_chunk``; ``mv``: the matvec's), and the model options."""

    obs: SparseObs
    npts: int
    nf: int
    f0: float
    full: tuple
    chunks: tuple
    mv: tuple
    huber_delta: float | None
    robust_kind: str
    model: str | None
    remat: bool
    f_dt: torch.dtype | None
    timer: object
    axis: str | None = None


class _State(NamedTuple):
    """The current state's per-observation data: the camera table, the
    points (3, P), and (stored mode) the factor rows (24, N), residuals
    (2, N) and effective weights (N,)."""

    tab: torch.Tensor
    X: torch.Tensor
    fac: torch.Tensor | None
    res: torch.Tensor | None
    w: torch.Tensor | None


def _chunk_factors(pb: _Problem, st: _State, ch: _Chunk, dt, perm=None):
    """(a1, a2, b1, b2, res, w) of a chunk, its columns in the order
    ``perm`` (local indices) when given: the stored rows, upcast, or
    recomputed (``factor_mode="recompute"``)."""
    s, e = ch.start, ch.end
    if not pb.remat:
        f, res, w = st.fac[:, s:e], st.res[:, s:e], st.w[s:e]
        if perm is not None:
            f, res, w = (t.index_select(-1, perm) for t in (f, res, w))
        f = f.to(dt)
        return f[0:3], f[3:6], f[6:15], f[15:24], res, w
    o = pb.obs
    cols = (o.point_idx[s:e], o.cam_idx[s:e], o.xy[:, s:e], o.weights[s:e])
    if perm is not None:
        cols = tuple(t.index_select(-1, perm) for t in cols)
    return _factor_cols(st.tab, st.X, *cols, pb.f0, pb.huber_delta, pb.model, pb.robust_kind)


def _state_of(pb: _Problem, cam: BAState, X: torch.Tensor, dist) -> _State:
    """The per-observation data of (cam, X): in stored mode the factor rows
    of the whole list, computed at once without a distortion and in chunks
    of ``obs_chunk`` with one (the chain's (C, k) views)."""
    tab = _cam_table(cam, pb.f0, dist)
    if pb.remat:
        return _State(tab, X, None, None, None)
    o = pb.obs
    n, dt = o.n_obs, X.dtype
    fac = torch.empty((24, n), dtype=pb.f_dt or dt, device=X.device)
    res = torch.empty((2, n), dtype=dt, device=X.device)
    w = torch.empty((n,), dtype=dt, device=X.device)
    for ch in (pb.full if dist is None else pb.chunks):
        s, e = ch.start, ch.end
        a1, a2, b1, b2, res[:, s:e], w[s:e] = _factor_cols(
            tab, X, o.point_idx[s:e], o.cam_idx[s:e], o.xy[:, s:e], o.weights[s:e], pb.f0,
            pb.huber_delta, pb.model, pb.robust_kind)
        fac[:, s:e] = torch.cat([a1, a2, b1, b2])
    return _State(tab, X, fac, res, w)


class _PointSide(NamedTuple):
    e_w: torch.Tensor  # weighted E at the current state
    d_P: torch.Tensor  # (3, P) point gradient
    matE6: torch.Tensor  # (6, P) undamped point blocks, identity where unseen


def _point_side(pb: _Problem, st: _State) -> _PointSide:
    """The point gradient, the point blocks and the weighted error: one
    pass (independent of the damping, so one per outer iteration)."""
    dt = st.X.dtype
    acc = st.X.new_zeros((10, pb.npts))
    e_w = st.X.new_zeros(())
    for ch in (pb.chunks if pb.remat else pb.full):
        a1, a2, b1, b2, res, w = _chunk_factors(pb, st, ch, dt)
        w2 = 2.0 * w
        e_w = e_w + torch.sum(w * (res[0] ** 2 + res[1] ** 2))
        i, j = _E6
        rows = torch.cat([w2 * (res[0] * a1 + res[1] * a2),
                          w2 * (a1[list(i)] * a1[list(j)] + a2[list(i)] * a2[list(j)]), w[None]])
        _pt_add(acc, rows, ch)
    unseen = (acc[9] <= 0).to(dt)
    matE6 = acc[3:9].clone()
    matE6[:3] += unseen
    return _PointSide(_psum(e_w, pb.axis), acc[:3], matE6)


class _System(NamedTuple):
    """One retry's damped system."""

    einv6: torch.Tensor  # (6, P) inverse damped point blocks
    matGc: torch.Tensor  # (F, 9, 9) damped camera blocks
    m_inv: torch.Tensor  # (F, 9, 9) SCHUR_JACOBI preconditioner
    rhs: torch.Tensor  # (9F,)
    d_F: torch.Tensor  # (9F,) camera gradient, gauge-masked
    diag_g: torch.Tensor  # (9F,) undamped camera-block diagonal
    seen_c: torch.Tensor  # (F,)


def _camera_side(pb: _Problem, st: _State, ps: _PointSide, free, c) -> _System:
    """The damped point inverses, the camera blocks G, the SCHUR_JACOBI
    correction sum_n alpha11 b1 b1^T + alpha12 (b1 b2^T + b2 b1^T) + alpha22
    b2 b2^T (alpha_ij = w2^2 a_i^T Einv a_j), the camera gradient and the
    rhs b = F^T Einv d_P - d_F: one pass over chunks of ``obs_chunk``, each
    gathered into camera order, so its (C, 45) block products stay
    bounded."""
    dt = st.X.dtype
    nf = pb.nf
    e6 = ps.matE6.clone()
    e6[:3] *= 1.0 + c
    einv6 = _sym3_inv(e6)
    ew = torch.cat([einv6, _sym3_matvec(einv6, ps.d_P)])  # (9, P): Einv, Einv d_P
    i9, j9 = list(_T9[0]), list(_T9[1])
    acc = st.X.new_zeros((109, nf))
    o = pb.obs
    for ch in pb.chunks:
        a1, a2, b1, b2, res, w = _chunk_factors(pb, st, ch, dt, ch.c_perm)
        w2 = 2.0 * w
        g = ew.index_select(1, o.point_idx[ch.start:ch.end].index_select(0, ch.c_perm))
        ea1, ea2 = _sym3_matvec(g[:6], a1), _sym3_matvec(g[:6], a2)
        ww = w2 * w2
        al11, al12, al22 = ww * (a1 * ea1).sum(0), ww * (a1 * ea2).sum(0), ww * (a2 * ea2).sum(0)
        r1, r2 = w2 * (a1 * g[6:]).sum(0), w2 * (a2 * g[6:]).sum(0)
        b1i, b1j, b2i, b2j = b1[i9], b1[j9], b2[i9], b2[j9]
        rows = torch.cat([
            w2 * (res[0] * b1 + res[1] * b2), r1 * b1 + r2 * b2,
            w2 * (b1i * b1j + b2i * b2j),
            al11 * b1i * b1j + al12 * (b1i * b2j + b2i * b1j) + al22 * b2i * b2j, w[None]])
        acc += _seg_sum(rows, ch.c_off)
    acc = _psum(acc, pb.axis)
    d_F = acc[0:9].T.reshape(-1) * free
    b_f = acc[9:18].T.reshape(-1)
    matG = _sym45_to_blocks(acc[18:63])
    corr = _sym45_to_blocks(acc[63:108])
    seen_c = (acc[108] > 0).to(dt)
    eye = torch.eye(9, dtype=dt, device=st.X.device)
    matGc = matG + c * matG * eye
    # the block-Jacobi preconditioner: the true Schur diagonal blocks,
    # gauge-projected, then inverted (fixed coordinates get identity rows)
    free_b = free.view(nf, 9)
    m_blocks = (matGc - corr) * (free_b[:, :, None] * free_b[:, None, :])
    m_blocks = m_blocks + eye * (1.0 - free_b + (1.0 - seen_c)[:, None] * free_b)[:, :, None]
    diag_g = torch.diagonal(matG, dim1=-2, dim2=-1).reshape(-1)
    return _System(einv6, matGc, inv9_spd(m_blocks), (b_f - d_F) * free, d_F, diag_g, seen_c)


def _f_point_rows(pb: _Problem, st: _State, v: torch.Tensor) -> torch.Tensor:
    """F v as (3, P) point rows: per observation u = w2 (b . v_cam), summed
    into point segments as u1 a1 + u2 a2. v is (9F,)."""
    dt = st.X.dtype
    vt = v.view(pb.nf, 9).T.contiguous()
    acc = st.X.new_zeros((3, pb.npts))
    for ch in pb.mv:
        a1, a2, b1, b2, _, w = _chunk_factors(pb, st, ch, dt)
        v_g = vt.index_select(1, pb.obs.cam_idx[ch.start:ch.end])
        w2 = 2.0 * w
        _pt_add(acc, w2 * (b1 * v_g).sum(0) * a1 + w2 * (b2 * v_g).sum(0) * a2, ch)
    return acc


def _ft_cam_rows(pb: _Problem, st: _State, w_p: torch.Tensor) -> torch.Tensor:
    """F^T w as (F, 9): per observation r = w2 (a . w_point), summed into
    camera segments as r1 b1 + r2 b2. w_p is (3, P)."""
    dt = st.X.dtype
    acc = st.X.new_zeros((9, pb.nf))
    for ch in pb.mv:
        a1, a2, b1, b2, _, w = _chunk_factors(pb, st, ch, dt)
        w_g = w_p.index_select(1, pb.obs.point_idx[ch.start:ch.end])
        w2 = 2.0 * w
        acc += _cam_sum(w2 * (a1 * w_g).sum(0) * b1 + w2 * (a2 * w_g).sum(0) * b2, ch)
    return _psum(acc, pb.axis).T


def _schur_matvec(pb: _Problem, st: _State, sy: _System, free, v: torch.Tensor) -> torch.Tensor:
    """S v for the damped, gauge-projected Schur complement, matrix-free,
    O(n_obs); identity on the gauge-fixed coordinates."""
    with span(pb.timer, "matvec"):
        vm = (v * free).view(pb.nf, 9)
        w_p = _sym3_matvec(sy.einv6, _f_point_rows(pb, st, vm.reshape(-1)))
        fe_fv = _ft_cam_rows(pb, st, w_p)
        gv = torch.einsum("fij,fj->fi", sy.matGc, vm)
        sv = (gv + (1.0 - sy.seen_c)[:, None] * vm - fe_fv).reshape(-1) * free
        return sv + (1.0 - free) * v


def _pcg(matvec, precond, b, tol: float, max_iter: int, x0=None, timer=None):
    """Preconditioned conjugate gradients with the relative-residual stop
    ||r||^2 <= tol^2 ||b||^2. ``x0`` warm-starts (one extra matvec for the
    true initial residual). The host reads the convergence flag every
    ``_CG_CHECK`` iterations; a converged iteration keeps x, r and p (zero
    step) and is not counted, so (x, count) equal a loop that stops at
    once. Each host read (the flag, the final count) is a ``host_read``
    span of ``timer``. Returns (x, iterations)."""
    tol2 = (tol * tol) * torch.clamp_min(torch.dot(b, b), 1e-30)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = precond(r)
    p = z
    active = torch.dot(r, r) > tol2
    n_iter = torch.zeros((), dtype=torch.int64, device=b.device)
    for k in range(max_iter):
        if k % _CG_CHECK == 0:
            with span(timer, "host_read"):
                stop = not bool(active)
            if stop:
                break
        ap = matvec(p)
        pap = torch.dot(p, ap)
        rz = torch.dot(r, z)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r - alpha * ap, r)
        z1 = precond(r)
        beta = torch.dot(r, z1) / torch.where(rz != 0, rz, 1.0)
        p = torch.where(active, z1 + beta * p, p)
        z = torch.where(active, z1, z)
        n_iter += active
        active = active & (torch.dot(r, r) > tol2)
    with span(timer, "host_read"):
        n_iter = int(n_iter)
    return x, n_iter


def _weights_fn(pb: _Problem, cam: BAState, X: torch.Tensor, dist):
    """ch -> a chunk's effective weights at (cam, X): the input weights
    times the IRLS weights of its residuals."""
    o = pb.obs
    if pb.huber_delta is None:
        return lambda ch: o.weights[ch.start:ch.end]
    rtab = _cam_table(cam, pb.f0, dist, geometry=False)

    def weights(ch):
        s, e = ch.start, ch.end
        w = o.weights[s:e]
        rp, rq = _residual_cols(rtab, X, o.point_idx[s:e], o.cam_idx[s:e], o.xy[:, s:e], w,
                                pb.f0, pb.model)
        return w * robust_weight(torch.sqrt(rp**2 + rq**2), pb.huber_delta, pb.robust_kind)

    return weights


def _trial_error(pb: _Problem, cam: BAState, X: torch.Tensor, dist, w_of) -> torch.Tensor:
    """Sum of weighted squared residuals at (cam, X); ``w_of(ch)`` gives a
    chunk's weights (the current state's IRLS weights). Without a
    distortion in stored mode one pass over the whole list, else chunks of
    ``obs_chunk``."""
    rtab = _cam_table(cam, pb.f0, dist, geometry=False)
    o = pb.obs
    e = X.new_zeros(())
    for ch in (pb.chunks if (pb.remat or dist is not None) else pb.full):
        s, t = ch.start, ch.end
        w = w_of(ch)
        rp, rq = _residual_cols(rtab, X, o.point_idx[s:t], o.cam_idx[s:t], o.xy[:, s:t], w,
                                pb.f0, pb.model)
        e = e + torch.sum(w * (rp**2 + rq**2))
    return _psum(e, pb.axis)


def lm_optimize_sparse(
    obs: SparseObs,
    state0: BAState,
    free: torch.Tensor,
    f0: float,
    config: LMConfig,
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    init_c=None,
    init_nu=None,
    dist=None,
    axis_name: str | None = None,
    factor_dtype=None,
    matvec_chunk: int | None = None,
    factor_mode: str = "stored",
    timer=None,
    plans: dict | None = None,
):
    """Observation-list LM with the dense core's protocol, the camera step
    solved by SCHUR_JACOBI-preconditioned CG. Returns (state, error, c, nu,
    n_iter, total_solver_retries, cg_iters_total, log, converged); the log
    is the (max_iter + 1,) E curve with ``config.record_log``, else None.

    ``factor_dtype`` ("bfloat16") stores the 24 factor rows narrow; every
    product upcasts them first, and residuals, weights and every P- or
    F-sized quantity stay in the working dtype, so each step solves a
    slightly perturbed system while acceptance is judged exactly.
    ``factor_mode="recompute"`` stores no factor rows: every pass recomputes
    them chunk by chunk, the same operator in another summation order.
    ``matvec_chunk`` chunks the CG matvec and back-substitution (default:
    the whole list in stored mode, ``obs_chunk`` in recompute mode).
    ``timer`` (``runtime.profiling.EventTimer``) records the spans
    "build" (once an LM iteration around "state", the factor rows, and
    "point_side", the point blocks and gradient; once a retry around
    "camera_side", the damped camera system), "matvec" (each PCG matvec)
    and "host_read" (each blocking read: PCG's convergence flag and count,
    the retry's decision). ``plans`` caches the chunk plans across calls
    on one list.

    ``axis_name``: the list is this rank's block of a point-partitioned
    list (``parallel/sharded_ba_sparse.py``), ``state0.X`` its points, and
    the camera-side sums are all-reduced over the axis (see the module
    docstring); an axis name that no sharded call binds raises
    ``ValueError``."""
    model = _check_config(config, dist)
    if factor_mode not in ("stored", "recompute"):
        raise ValueError(f"unknown factor_mode: {factor_mode!r}")
    remat = factor_mode == "recompute"
    if isinstance(factor_dtype, str):
        factor_dtype = getattr(torch, factor_dtype)
    dt = obs.xy.dtype
    n = obs.n_obs
    npts, nf = state0.X.shape[0], state0.f.shape[0]
    robust_kind = resolve_robust(config.robust)
    huber_delta = config.huber_delta if robust_kind is not None else None
    plans = {} if plans is None else plans
    pb = _Problem(obs, npts, nf, f0, _cached_plan(plans, obs, nf, n),
                  _cached_plan(plans, obs, nf, obs_chunk),
                  _cached_plan(plans, obs, nf, matvec_chunk or (obs_chunk if remat else n)),
                  huber_delta,
                  robust_kind or "huber", model if dist is not None else None, remat,
                  None if remat else factor_dtype, timer, axis_name)
    cam = state0._replace(X=state0.X[:0])
    X = state0.X.T.contiguous()  # (3, P)

    e_prev = _trial_error(pb, cam, X, dist, _weights_fn(pb, cam, X, dist))
    log_e = [e_prev] if config.record_log else None
    nielsen = config.damping == "nielsen"
    c = as_tensor(config.init_damping if init_c is None else init_c, obs.xy.device, dt)
    nu = as_tensor(2.0 if init_nu is None else init_nu, obs.xy.device, dt)
    n_iter = n_retries = cg_total = 0
    done = False
    while n_iter < config.max_iter:
        with span(timer, "build"):
            with span(timer, "state"):
                st = _state_of(pb, cam, X, dist)
            with span(timer, "point_side"):
                ps = _point_side(pb, st)
        accepted = False
        tries = 0
        e_base = ps.e_w if huber_delta is not None else e_prev
        delta_prev = None
        while not accepted and tries < config.max_inner_retries:
            with span(timer, "build"), span(timer, "camera_side"):
                sy = _camera_side(pb, st, ps, free, c)
            delta_xi, cg_iters = _pcg(
                lambda v: _schur_matvec(pb, st, sy, free, v),
                lambda v: torch.einsum("fij,fj->fi", sy.m_inv, v.view(nf, 9)).reshape(-1),
                sy.rhs, cg_tol, cg_max_iter, x0=delta_prev, timer=timer)
            delta_xi = delta_xi * free
            # back-substitute the points: delta_X = -Einv (F delta + d_P)
            delta_X = -_sym3_matvec(sy.einv6, _f_point_rows(pb, st, delta_xi) + ps.d_P)
            X_new = X + delta_X
            trial_cam = _apply_update(cam, delta_xi, cam.X)
            if remat:
                e_trial = _trial_error(pb, trial_cam, X_new, dist, _weights_fn(pb, cam, X, dist))
            else:
                e_trial = _trial_error(pb, trial_cam, X_new, dist,
                                       lambda ch: st.w[ch.start:ch.end])
            acc_t = e_trial <= e_base
            pred = None
            if nielsen:
                # the point-side sums of the gain ratio, all-reduced together
                pts = _psum(torch.stack([torch.sum(delta_X * ps.matE6[:3] * delta_X),
                                         torch.sum(ps.d_P * delta_X)]), axis_name)
                dDd = pts[0] + torch.sum(delta_xi * sy.diag_g * delta_xi)
                g_d = pts[1] + torch.sum(sy.d_F * delta_xi)
                pred = 0.5 * (c * dDd - g_d)
            c, nu = _lm_damping(config, acc_t, c, nu, e_base, e_trial, pred)
            tries += 1
            cg_total += cg_iters
            # the one host read of the retry: accepted, converged if so, and
            # whether the step is finite
            flags = torch.stack([acc_t, torch.abs(e_trial - e_base) <= config.delta_tol,
                                 torch.isfinite(delta_xi).all()])
            with span(timer, "host_read"):
                accepted, done, finite = flags.tolist()
            # the retry warm-starts from the rejected step; a non-finite one
            # (a float32 preconditioner block that is not positive definite
            # at small damping gives NaN) would poison every later retry
            delta_prev = delta_xi if finite else None
        if accepted:
            cam, X, e_new = trial_cam, X_new, e_trial
        else:  # never accepted (divergence/NaN): keep the state and stop
            e_new, done = e_base, True
        if not nielsen:
            c = c / config.divisor
        n_iter += 1
        n_retries += tries
        e_prev = e_new
        if log_e is not None:
            log_e.append(e_new)
        if done:
            break
    log = None
    if log_e is not None:
        log = torch.zeros((config.max_iter + 1,), dtype=dt, device=obs.xy.device)
        log[: len(log_e)] = torch.stack(log_e)
    return (cam._replace(X=X.T.contiguous()), e_prev, c, nu, n_iter, n_retries, cg_total, log,
            bool(done))


def fit_distortion_sparse(state: BAState, obs: SparseObs, f0: float, shared: bool = False,
                          huber_delta: float | None = None, dist=None, model: str | None = None,
                          robust_kind: str = "huber", axis_name: str | None = None,
                          obs_chunk: int = 1 << 16, plans: dict | None = None) -> torch.Tensor:
    """The distortion refit on the observation list: the dense core's
    per-camera normal-equation accumulands (every family, through
    ``_refit_rounds``/``_refit_terms``/``_refit_solve``) evaluated per
    observation in chunks of ``obs_chunk``, then summed per camera, and
    over the ranks of ``axis_name`` before each solve. With
    ``huber_delta`` the terms are IRLS-weighted by the residuals of the
    model ``dist`` the refit starts from. ``state.X`` is (P, 3)."""
    if model is None:
        model = resolve_distortion_model(dist, "auto")
    nf = state.f.shape[0]
    chunks = _cached_plan({} if plans is None else plans, obs, nf, obs_chunk)
    cam = state._replace(X=state.X[:0])
    X = state.X.T.contiguous()
    tab = _cam_table(cam, f0, geometry=False)
    cur = default_distortion(model, nf, obs.xy.dtype, obs.xy.device) if dist is None else dist
    rtab = _cam_table(cam, f0, dist, geometry=False)
    pi, ci = obs.point_idx, obs.cam_idx
    weights = []
    for ch in chunks:
        s, e = ch.start, ch.end
        w = obs.weights[s:e]
        if huber_delta is not None:
            rp, rq = _residual_cols(rtab, X, pi[s:e], ci[s:e], obs.xy[:, s:e], w, f0, model)
            w = w * robust_weight(torch.sqrt(rp**2 + rq**2), huber_delta, robust_kind)
        weights.append(w)
    for round_ in _refit_rounds(model):
        terms = X.new_zeros((distortion_nterms(model), nf))
        for ch, w in zip(chunks, weights):
            s, e = ch.start, ch.end
            g = tab.index_select(1, ci[s:e])
            p, q, r = _pqr(g, X.index_select(1, pi[s:e]), w)
            t = _refit_terms(_chain_state(g[_F], g[_U].T), p[None], q[None], r[None],
                             obs.xy[:, s:e].T[None], w[None], f0, model,
                             cur.index_select(0, ci[s:e]), round_)  # (C, nterms)
            terms += _cam_sum(t.T, ch)
        cur = _refit_solve(_psum(terms, axis_name).T, cur, model, round_, shared)
    return cur


def bundle_adjust_sparse(
    obs: SparseObs,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    init_c=None,
    init_nu=None,
    distortion=None,
    factor_dtype=None,
    matvec_chunk: int | None = None,
    factor_mode: str = "stored",
    device=None,
    timer=None,
) -> BAResult:
    """Bundle adjustment over an observation list, O(n_obs) memory, for
    BAL-class sparsity where the (P, F) layout of the other cores cannot
    hold the problem. The LM protocol, gauge, distortion alternation
    (``config.distortion_rounds``: refit, then an LM segment), robust
    losses and resume through ``init_c``/``init_nu`` are ``bundle_adjust``'s;
    the camera step is solved matrix-free by preconditioned CG, so results
    agree with the dense core to ``cg_tol``. Runs on the card unless
    ``device`` says otherwise; the working dtype is ``obs.xy``'s.

    The log holds ``n_solver_retries`` and ``cg_iters_total`` of the last
    LM segment (as the JAX package), ``n_solver_retries_total`` of every
    segment, the final ``c`` and ``nu``, ``converged`` (the |dE| <=
    delta_tol or never-accepted stop, which a segmented driver needs) and,
    with ``record_log``, the E curve of the last segment."""
    obs = obs.to(resolve_device(device))
    return _adjust_list(obs, init_X, init_K, init_R, init_t, f0, axis, config, distortion,
                        init_c, init_nu, cg_tol=cg_tol, cg_max_iter=cg_max_iter,
                        obs_chunk=obs_chunk, factor_dtype=factor_dtype,
                        matvec_chunk=matvec_chunk, factor_mode=factor_mode, timer=timer)


def _adjust_list(obs: SparseObs, init_X, init_K, init_R, init_t, f0: float, axis: str,
                 config: LMConfig, distortion, init_c=None, init_nu=None, gather=None,
                 **kw) -> BAResult:
    """``bundle_adjust_sparse`` on a list already on its device, shared with
    the point-sharded driver (``parallel/sharded_ba_sparse.py``): the
    gauge, the intrinsics, the distortion model and its
    ``config.distortion_rounds`` of refit then LM segment, the log and the
    result. ``init_X`` holds the list's points; ``gather`` takes the final
    (P, 3) points to the whole cloud (None: they are the cloud). ``kw``
    goes to ``lm_optimize_sparse``, its ``axis_name`` to the refit too."""
    dev, dt = obs.xy.device, obs.xy.dtype
    K0 = as_tensor(init_K, dev, dt)
    nf = K0.shape[0]
    X0, R0, t0, info = normalize_gauge(as_tensor(init_X, dev, dt), as_tensor(init_R, dev, dt),
                                       as_tensor(init_t, dev, dt), axis)
    f_in, u_in = intrinsics_from_K(K0, f0)
    state0 = BAState(X=X0, f=f_in, u=u_in, t=t0, R=R0)
    free = gauge_mask(nf, axis, dt, dev)
    dist = None if distortion is None else as_tensor(distortion, dev, dt)
    model = resolve_distortion_model(dist, config.distortion_model)
    if config.distortion_rounds > 0 and dist is None:
        dist = default_distortion(model, nf, dt, dev)
    robust_kind = resolve_robust(config.robust)
    kw["plans"] = {}
    n_seg = retries_seg = 0
    c_seg, nu_seg = init_c, init_nu
    seg_cfg = dataclasses.replace(config, record_log=False)
    for _ in range(config.distortion_rounds):
        dist = fit_distortion_sparse(
            state0, obs, f0, shared=config.distortion_shared,
            huber_delta=config.huber_delta if robust_kind is not None else None, dist=dist,
            model=model, robust_kind=robust_kind or "huber", axis_name=kw.get("axis_name"),
            obs_chunk=kw["obs_chunk"], plans=kw["plans"])
        state0, _, c_seg, nu_seg, n_it, r_it, *_ = lm_optimize_sparse(
            obs, state0, free, f0, seg_cfg, init_c=c_seg, init_nu=nu_seg, dist=dist, **kw)
        n_seg += n_it
        retries_seg += r_it
    final, e, c_f, nu_f, n_iter, n_retries, cg_total, scalar_log, done = lm_optimize_sparse(
        obs, state0, free, f0, config, init_c=c_seg, init_nu=nu_seg, dist=dist, **kw)
    X = final.X if gather is None else gather(final.X)
    Xg, Rg, tg = restore_gauge(info, X, final.R, final.t)
    log = {"n_solver_retries": n_retries, "n_solver_retries_total": n_retries + retries_seg,
           "c": c_f, "nu": nu_f, "cg_iters_total": cg_total, "converged": done}
    if scalar_log is not None:
        log["reprojection_error"] = scalar_log
    return BAResult(X=Xg, K=build_K(final.f, final.u, f0), R=Rg, t=tg, error=e,
                    n_iter=n_iter + n_seg, log=log, distortion=dist)
