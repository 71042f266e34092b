"""Chunk-streamed bundle adjustment for the 100k-point regime.

Counterpart of ``mvrecon_tpu/models/bundle_adjustment_chunked.py``: per LM
retry one pass over point chunks builds the reduced camera system, one
Cholesky solve gives the camera step, and a second pass back-substitutes
each chunk's point update and sums the trial error. Only one chunk's
derivative planes live at a time.

Two builds: the fused one (``ops/fused_schur.py``, the K2 kernel on the
card) runs the pinhole and the BAL radial models; every other distortion
family (OPENCV, fisheye, full OPENCV, FOV, thin prism), whose chain the
fused planes do not carry, takes the non-fused build (``_build_system``):
per chunk the camera-major blocks, Y = L⁻¹F written K-major, and K1's
lower tiles of YᵀY summed into one accumulator that is mirrored once after
the chunks. On the card a float32 Y goes through K1
or raises; there is no library product in its place.

The damping protocol, stopping rules and gauge are the JAX package's: the
reference and Nielsen schedules with the c <= 1e25 / nu <= 1e12 clamps,
``accept_divisor``, ``init_c``/``init_nu`` resume, ``jacobi_scaling``, and
Kahan-compensated decision scalars. A damped system that is not positive
definite gives a NaN step, which rejects the trial and raises the damping,
as ``cho_factor``'s NaNs do there. The per-chunk scalars stay on the
device; the host reads the accept flag once per retry.

The non-fused per-chunk blocks (``_chunk_factors``, ``_point_grad_and_block``,
``_chunk_blocks``, ``_damped_schur_factor``, ``_chunk_backsub`` in
``bundle_adjustment.py``) serve the non-fused build, the dense and the
host-streamed cores.

Robust losses run as IRLS, as in the JAX package: every retry's build
weights each observation from its residual at the current state, and the
accept test, the Nielsen gain ratio and the stop test compare with the
weighted E that build returns. ``distortion_rounds`` alternates the refit
(``fit_distortion_chunked``: one pass over the chunks for the models linear
in their parameters, eight for the full-OPENCV alternation, six for the FOV
Gauss-Newton steps) with LM segments, as the dense core does.

Under ``axis_name`` (``parallel/sharded_ba.py``: this rank's shard of the
points, chunked) the non-fused build runs whatever the model, as in the
JAX package, and the sums over points are all-reduced where JAX ``psum``s
them: the packed K1 accumulator before its one mirror, b_p, matG, d_F
and E after each rank's compensated sum in the build; the trial E and
the gain ratio's point side after the back-substitution; the first E;
and each refit pass's terms.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import LMConfig, as_tensor
from ..ops.fused_schur import (
    assemble_type_major,
    finish_schur,
    fused_backsub_chunk,
    fused_chunk_update,
    schur_acc_dim,
    type_major_to_camera_major,
)
from ..ops.syrk import finish_syrk_accumulator, syrk_accumulator_dim, syrk_lower_accumulate
from .bundle_adjustment import (
    BAResult,
    BAState,
    _apply_update,
    _check_config,
    _chol_solve,
    _chunk_backsub,
    _chunk_blocks,
    _damp,
    _chunk_distortion_terms,
    _damped_schur_factor,
    _lm_damping,
    _prepare_distortion,
    _prepare_problem,
    _psum,
    _reduced_camera_system,
    _refit_rounds,
    _refit_solve,
    _state_error,
    build_K,
    default_distortion,
    distortion_nterms,
    resolve_distortion_model,
    resolve_robust,
    restore_gauge,
)


def _kadd(acc, x):
    """One Kahan compensated-summation step on a (sum, comp) pair: the LM
    accept test and the Nielsen gain ratio read sums of per-chunk partials,
    and compensation removes their accumulation-order noise."""
    s, comp = acc
    y = x - comp
    t = s + y
    return (t, (t - s) - y)


def _build_system_fused(cam, X_ch, x_ch, vis_ch, free, f0, c, huber_delta=None,
                        robust_kind="huber", dist=None):
    """Fused generate-and-reduce build over the chunks, IRLS-weighted with
    ``huber_delta`` and through the radial model with ``dist``.

    Returns (A', b', E_now (weighted with ``huber_delta``), (diag_g, d_F),
    free_tm) in type-major layout."""
    nf = cam.f.shape[0]
    dt = x_ch[0].dtype
    dev = x_ch[0].device
    f_pad, n_acc = schur_acc_dim(nf)
    acc = torch.zeros((n_acc, n_acc), dtype=dt, device=dev)
    g = torch.zeros((nf, 9, 9), dtype=dt, device=dev)
    d_f = torch.zeros((9 * nf,), dtype=dt, device=dev)
    bp = torch.zeros((9, f_pad), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    e_acc = (zero, zero)
    for X_c, x_c, vis_c in zip(X_ch, x_ch, vis_ch):
        acc, d_F, matG, e_chunk, b_p = fused_chunk_update(acc, cam, X_c, x_c, vis_c, f0, c,
                                                          huber_delta, robust_kind, dist)
        g = g + matG
        d_f = d_f + d_F
        e_acc = _kadd(e_acc, e_chunk)
        bp = bp + b_p
    d_f = d_f * free
    a, b, free_tm = assemble_type_major(finish_schur(acc), bp.reshape(-1), g, d_f, free, c, nf, f_pad)
    diag_g = torch.diagonal(g, dim1=-2, dim2=-1).reshape(-1)  # (9F,) undamped
    return a, b, e_acc[0], (diag_g, d_f), free_tm


def _build_system(cam, X_ch, x_ch, vis_ch, free, f0, c, huber_delta=None,
                  robust_kind="huber", dist=None, model=None, axis_name=None):
    """Non-fused build over the chunks, camera-major: per chunk the blocks
    (IRLS-weighted with ``huber_delta``, through the distortion model with
    ``dist``), Y = L⁻¹F and yd = L⁻¹ d_P (``_damped_schur_factor``), and
    K1's lower tiles of YᵀY added into one accumulator; one mirror after
    the chunks (``finish_syrk_accumulator``). With ``axis_name`` the
    packed accumulator, b_p, matG, d_F and E are all-reduced first.

    Returns (A (9F, 9F) damped, with identity rows on the gauge-fixed
    parameters, b (9F,), E_now (weighted with ``huber_delta``),
    (diag_g, d_F))."""
    nf = cam.f.shape[0]
    nf9 = 9 * nf
    dt = x_ch[0].dtype
    dev = x_ch[0].device
    n_acc = syrk_accumulator_dim(nf9)
    acc = torch.zeros((n_acc, n_acc), dtype=dt, device=dev)
    b_p = torch.zeros((nf9,), dtype=dt, device=dev)
    g = torch.zeros((nf, 9, 9), dtype=dt, device=dev)
    d_f = torch.zeros((nf9,), dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    e_acc = (zero, zero)
    for X_c, x_c, vis_c in zip(X_ch, x_ch, vis_ch):
        d_P, d_F, matE, matF, matG, e_chunk = _chunk_blocks(cam, X_c, x_c, vis_c, free, f0,
                                                            huber_delta, robust_kind, dist, model)
        y_t, yd = _damped_schur_factor(matE, matF, d_P, c)
        del matF
        syrk_lower_accumulate(acc, y_t.T)
        b_p = b_p + y_t @ yd.reshape(-1)
        g = g + matG
        d_f = d_f + d_F
        e_acc = _kadd(e_acc, e_chunk)
    schur = finish_syrk_accumulator(_psum(acc, axis_name), nf9)
    del acc
    b_p, g, d_f = (_psum(v, axis_name) for v in (b_p, g, d_f))
    a = _reduced_camera_system(schur, _damp(g, c), free)
    diag_g = torch.diagonal(g, dim1=-2, dim2=-1).reshape(-1)  # (9F,) undamped
    return a, b_p - d_f, _psum(e_acc[0], axis_name), (diag_g, d_f)


def _backsub_and_trial(cam, trial_cam, X_ch, x_ch, vis_ch, free, f0, c, delta_xi,
                       huber_delta=None, robust_kind="huber", dist=None, model=None,
                       fused=True, axis_name=None):
    """Per chunk: back-substitute the point update at the current state and
    sum the trial error under the updated cameras (under the current
    state's IRLS weights with ``huber_delta``, through the distortion model
    with ``dist``), from the type-major planes (``fused``) or the
    camera-major factors.

    Returns (X_new chunks, E_trial, dDd_pts, g_d_pts), the three sums
    all-reduced with ``axis_name``."""
    zero = torch.zeros((), dtype=x_ch[0].dtype, device=x_ch[0].device)
    e_acc = dDd_acc = gd_acc = (zero, zero)
    X_new = []
    for X_c, x_c, vis_c in zip(X_ch, x_ch, vis_ch):
        if fused:
            X_n, e_c, dDd_c, gd_c = fused_backsub_chunk(
                cam, trial_cam, X_c, x_c, vis_c, f0, c, delta_xi * free, huber_delta,
                robust_kind, dist)
        else:
            X_n, e_c, dDd_c, gd_c = _chunk_backsub(cam, trial_cam, X_c, x_c, vis_c, free, c,
                                                   delta_xi, f0, huber_delta, robust_kind, dist,
                                                   model)
        X_new.append(X_n)
        e_acc, dDd_acc, gd_acc = _kadd(e_acc, e_c), _kadd(dDd_acc, dDd_c), _kadd(gd_acc, gd_c)
    return X_new, *(_psum(acc[0], axis_name) for acc in (e_acc, dDd_acc, gd_acc))


def _solve_cam(a: torch.Tensor, b: torch.Tensor, jacobi_scaling: bool) -> torch.Tensor:
    """Damped camera solve by Cholesky (a factor that fails gives a NaN
    step, ``_chol_solve``). With ``jacobi_scaling`` the system is
    symmetrically diag-scaled first."""
    if not jacobi_scaling:
        return _chol_solve(a, b)
    s = torch.rsqrt(torch.diagonal(a))
    return _chol_solve(a * (s[:, None] * s[None, :]), b * s) * s


def lm_optimize_chunked(
    x: torch.Tensor,
    state0: BAState,
    vis: torch.Tensor,
    free: torch.Tensor,
    f0: float,
    config: LMConfig,
    chunk_size: int,
    axis_name: str | None = None,
    init_c=None,
    init_nu=None,
    dist=None,
):
    """Chunk-streamed LM with the dense core's protocol, through the
    distortion model ``dist`` (held fixed) when given. The fused build
    runs the pinhole and the radial model, the non-fused build (K1 on the
    card) every other family, and every model under ``axis_name`` (x, vis
    and state0.X are then this rank's shard; JAX fuses only unsharded).
    Returns (state, error, c, nu, n_iter, total_solver_retries, log): the
    log is ``{"reprojection_error": (max_iter + 1,)}`` with
    ``config.record_log`` (zero past the last iteration), else None."""
    model = _check_config(config, dist)
    fused = axis_name is None and (dist is None or model == "radial")
    npts = x.shape[0]
    dt = x.dtype
    dev = x.device
    pad = (-npts) % chunk_size
    X0 = state0.X
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=dt, device=dev)])
        vis = torch.cat([vis, torch.zeros((pad,) + vis.shape[1:], dtype=dt, device=dev)])
        X0 = torch.cat([X0, X0.mean(dim=0).expand(pad, 3)])
    x_ch = x.split(chunk_size)
    vis_ch = vis.split(chunk_size)
    cam = state0._replace(X=torch.zeros((0, 3), dtype=dt, device=dev))
    X_ch = list(X0.split(chunk_size))

    e_prev = torch.zeros((), dtype=dt, device=dev)
    for X_c, x_c, vis_c in zip(X_ch, x_ch, vis_ch):
        e_prev = e_prev + _state_error(cam._replace(X=X_c), x_c, vis_c, f0, dist, model)
    e_prev = _psum(e_prev, axis_name)

    log_e = [e_prev] if config.record_log else None
    nielsen = config.damping == "nielsen"
    robust_kind = resolve_robust(config.robust)
    huber_delta = None if robust_kind is None else config.huber_delta
    nf = cam.f.shape[0]
    f_pad, _ = schur_acc_dim(nf)
    c = as_tensor(config.init_damping if init_c is None else init_c, dev, dt)
    nu = as_tensor(2.0 if init_nu is None else init_nu, dev, dt)
    n_iter = 0
    n_retries = 0
    while n_iter < config.max_iter:
        accepted = False
        tries = 0
        e_base = e_prev
        while not accepted and tries < config.max_inner_retries:
            if fused:
                a, b, e_w, (diag_g, d_f), free_tm = _build_system_fused(
                    cam, X_ch, x_ch, vis_ch, free, f0, c, huber_delta, robust_kind, dist
                )
                delta_tm = _solve_cam(a, b, config.jacobi_scaling) * free_tm
                delta_xi = type_major_to_camera_major(delta_tm, nf, f_pad)
            else:
                a, b, e_w, (diag_g, d_f) = _build_system(
                    cam, X_ch, x_ch, vis_ch, free, f0, c, huber_delta, robust_kind, dist, model,
                    axis_name)
                delta_xi = _solve_cam(a, b, config.jacobi_scaling) * free
            del a, b
            if huber_delta is not None:
                e_base = e_w  # the weighted E at the current state
            trial_cam = _apply_update(cam, delta_xi, torch.zeros((0, 3), dtype=dt, device=dev))
            X_trial, e_trial, dDd_pts, gd_pts = _backsub_and_trial(
                cam, trial_cam, X_ch, x_ch, vis_ch, free, f0, c, delta_xi, huber_delta,
                robust_kind, dist, model, fused, axis_name
            )
            acc_t = e_trial <= e_base
            pred = None
            if nielsen:
                dDd = dDd_pts + torch.sum(delta_xi * diag_g * delta_xi)
                g_d = gd_pts + torch.sum(d_f * delta_xi)
                pred = 0.5 * (c * dDd - g_d)
            c, nu = _lm_damping(config, acc_t, c, nu, e_base, e_trial, pred)
            tries += 1
            # the one host read of the retry: accepted, and converged if so
            accepted, done = torch.stack(
                [acc_t, torch.abs(e_trial - e_base) <= config.delta_tol]
            ).tolist()
        if accepted:
            cam, X_ch, e_new = trial_cam, X_trial, e_trial
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

    X_full = torch.cat(X_ch)[:npts]
    log = None
    if log_e is not None:
        log_t = torch.zeros((config.max_iter + 1,), dtype=dt, device=dev)
        log_t[: len(log_e)] = torch.stack(log_e)
        log = {"reprojection_error": log_t}
    return cam._replace(X=X_full), e_prev, c, nu, n_iter, n_retries, log


def bundle_adjust_chunked(
    x,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    chunk_size: int = 4096,
    init_c=None,
    init_nu=None,
    distortion=None,
    device=None,
) -> BAResult:
    """Bundle adjustment with an O(chunk) memory footprint for the
    derivative planes. x (P, F, 2); the optional visibility is (P, F).
    Runs on the card unless ``device`` says otherwise; the working dtype
    is x's. The returned ``log`` carries the final damping (c, nu) so a
    segmented run resumes through ``init_c``/``init_nu``.

    ``distortion`` / ``config.distortion_rounds``: the BAL radial (fused
    build) or any other family (non-fused build), held fixed or alternated
    with its refit (``fit_distortion_chunked``) as in the dense core.
    ``n_iter`` counts every LM segment; as in the JAX package
    ``log["n_solver_retries"]`` and the recorded E cover the last segment,
    and ``log["n_solver_retries_total"]`` counts every segment's retries."""
    x, vis, state0, free, info = _prepare_problem(
        x, init_X, init_K, init_R, init_t, f0, visibility, axis, device
    )
    dist, model = _prepare_distortion(distortion, config, x.shape[1], 0, x.dtype, x.device)
    robust_kind = resolve_robust(config.robust)
    seg_cfg = dataclasses.replace(config, record_log=False)
    c_seg, nu_seg = init_c, init_nu
    n_seg_total = retries_seg = 0
    for _ in range(config.distortion_rounds):
        # refit first, then an LM segment, as the dense core
        dist = fit_distortion_chunked(
            state0, x, vis, f0, chunk_size, shared=config.distortion_shared,
            huber_delta=None if robust_kind is None else config.huber_delta, dist=dist,
            model=model, robust_kind=robust_kind or "huber")
        state0, _, c_seg, nu_seg, n_seg, r_seg, _ = lm_optimize_chunked(
            x, state0, vis, free, f0, seg_cfg, chunk_size, init_c=c_seg, init_nu=nu_seg,
            dist=dist)
        n_seg_total += n_seg
        retries_seg += r_seg

    final, e, c_f, nu_f, n_iter, n_retries, scalar_log = lm_optimize_chunked(
        x, state0, vis, free, f0, config, chunk_size, init_c=c_seg, init_nu=nu_seg, dist=dist,
    )
    Xg, Rg, tg = restore_gauge(info, final.X, final.R, final.t)
    log = {"n_solver_retries": n_retries, "n_solver_retries_total": n_retries + retries_seg,
           "c": c_f, "nu": nu_f}
    if scalar_log is not None:
        log.update(scalar_log)
    return BAResult(X=Xg, K=build_K(final.f, final.u, f0), R=Rg, t=tg, error=e,
                    n_iter=n_iter + n_seg_total, log=log, distortion=dist)


def fit_distortion_chunked(state: BAState, x, vis, f0: float, chunk_size: int,
                           shared: bool = False, huber_delta: float | None = None, dist=None,
                           axis_name=None, tangential: bool | None = None,
                           model: str | None = None, robust_kind: str = "huber") -> torch.Tensor:
    """The distortion refit (``fit_distortion``) with each pass's terms
    summed over point chunks, so no more than one chunk's terms exist at a
    time; it equals the dense refit on the same data. The full-OPENCV
    alternation and the FOV steps start from ``dist`` (``default_distortion``
    when None) and take one pass over the chunks each. With
    ``huber_delta`` the terms are IRLS-weighted by the residuals of the
    model ``dist``. The model follows ``dist``'s columns unless ``model``
    names it or ``tangential`` picks OPENCV (True) or radial (False). x
    (P, F, 2) and vis (P, F) or (P, 1) are tensors on one device; the tail
    chunk is padded with zero visibility. With ``axis_name`` each pass's
    terms are all-reduced before its solve."""
    if model is None:
        if tangential is None:
            model = resolve_distortion_model(dist, "auto")
        else:
            model = "opencv" if tangential else "radial"
    npts = x.shape[0]
    pad = (-npts) % chunk_size
    X = state.X
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        vis = torch.cat([vis, vis.new_zeros((pad,) + vis.shape[1:])])
        X = torch.cat([X, X.mean(dim=0).expand(pad, 3)])
    cam = state._replace(X=X[:0])
    nf = cam.f.shape[0]
    cur = default_distortion(model, nf, x.dtype, x.device) if dist is None else dist
    chunks = list(zip(X.split(chunk_size), x.split(chunk_size), vis.split(chunk_size)))
    for round_ in _refit_rounds(model):
        terms = x.new_zeros((nf, distortion_nterms(model)))
        for X_c, x_c, vis_c in chunks:
            terms = terms + _chunk_distortion_terms(cam, X_c, x_c, vis_c, f0, dist, model,
                                                    huber_delta, robust_kind, cur, round_)
        cur = _refit_solve(_psum(terms, axis_name), cur, model, round_, shared)
    return cur
