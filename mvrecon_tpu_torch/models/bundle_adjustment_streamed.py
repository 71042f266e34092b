"""Host-streamed bundle adjustment: the observations never reside on the
card whole.

Counterpart of ``mvrecon_tpu/models/bundle_adjustment_streamed.py``. At
1M points x 500 views the (P, F, 2) observation array alone takes 4 GB in
float32. Here it stays a NumPy array in host memory (with the optional
(P, F) visibility) and is streamed one point chunk at a time:

- the LM outer/retry protocol runs as a host-side loop;
- per damping attempt, pass 1 streams the chunks and folds each one's
  damped Schur and gradient contributions into device accumulators; the
  chunk's Schur term YᵀY goes through the packed lower-triangle SYRK
  (kernel K1, ``ops/syrk.py``);
- after the (9F, 9F) solve, pass 2 streams the chunks again to
  back-substitute the point updates and sum the trial error;
- the card holds O(chunk) observation bytes, the (9F, 9F) system and
  X (P, 3).

On the card the chunks move through ``_ChunkFeed``: pinned staging
buffers filled by a worker thread and copied on a dedicated stream,
``prefetch`` chunks ahead of the computation.

Under a robust loss each chunk's IRLS weights come from its residuals at
the current state, in both passes: pass 1 weights the blocks (and so the Y
that K1 reads) and returns the weighted E, the retry's accept baseline;
pass 2 sums the trial error under the same weights. No (P, F) weight
array exists.

Every distortion family runs through both passes and the starting error,
as in the dense core; with ``distortion_rounds`` each round's refit adds
streaming passes that sum its per-camera terms chunk by chunk: one for the
models linear in their parameters, eight for the full-OPENCV alternation,
six for the FOV Gauss-Newton steps.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..config import LMConfig, as_tensor, resolve_device, result_dtype
from ..ops.syrk import syrk
from ..runtime.profiling import span
from .bundle_adjustment import (
    BAResult,
    BAState,
    _apply_update,
    _chol_solve,
    _chunk_backsub,
    _chunk_blocks,
    _chunk_distortion_terms,
    _damp,
    _damped_schur_factor,
    _prepare_distortion,
    _reduced_camera_system,
    _refit_rounds,
    _refit_solve,
    _state_error,
    build_K,
    distortion_nterms,
    gauge_mask,
    intrinsics_from_K,
    normalize_gauge,
    resolve_robust,
    restore_gauge,
)


def _accumulate_chunk(accs, cam: BAState, X_c, x_c, vis_c, free, c: float, f0: float,
                      huber_delta=None, robust_kind: str = "huber", dist=None,
                      model: str | None = None, timer=None):
    """Fold one chunk's damped Schur/gradient contributions into the
    accumulators (schur, b, G, d_F, E) and return them. With
    ``huber_delta`` the blocks and the error are IRLS-weighted at the
    current state; with ``dist`` they go through the distortion model.
    The chunk's Schur term is K1's product of the K-major Y; ``timer``
    records it, with its mirror and its fold into the sum, as a ``k1``
    span."""
    schur_acc, b_acc, g_acc, df_acc, e_acc = accs
    d_P, d_F, matE, matF, matG, e_chunk = _chunk_blocks(cam, X_c, x_c, vis_c, free, f0,
                                                        huber_delta, robust_kind, dist, model)
    y_t, yd = _damped_schur_factor(matE, matF, d_P, c)
    del matF
    with span(timer, "k1"):
        schur_acc = schur_acc + syrk(y_t.T)
    b_acc = b_acc + y_t @ yd.reshape(-1)
    return (schur_acc, b_acc, g_acc + matG, df_acc + d_F, e_acc + e_chunk)


def _assemble_and_solve(accs, free, c: float):
    """Damped reduced camera system from the accumulators -> (delta_xi,
    E_now). A factorization that fails gives a NaN step."""
    schur, b_p, g, d_f, e_now = accs
    a = _reduced_camera_system(schur, _damp(g, c), free)
    return _chol_solve(a, b_p - d_f) * free, e_now


def _chunk_error(cam: BAState, X_c, x_c, vis_c, f0: float, dist=None, model: str | None = None):
    return _state_error(cam._replace(X=X_c), x_c, vis_c, f0, dist, model)


class _ChunkFeed:
    """Streams (x, vis) point chunks host -> device; ``x`` stays a NumPy
    array. Every chunk is ``chunk_size`` points: the ragged tail is padded
    with zero observations and zero visibility. Iterating yields
    ``(lo, hi, x_c, vis_c)``; ``vis_c`` is (C, F), or (C, 1) without a mask.

    On the card a ring of ``prefetch + 1`` slots, each a pinned host
    staging buffer and a device buffer, carries the chunks. A worker
    thread slices, pads and casts chunk i into a free slot's staging
    buffer and copies it with ``copy_(non_blocking=True)`` on a dedicated
    copy stream, ``prefetch`` chunks ahead of the consumer; the compute
    stream waits on that copy's event before it uses the chunk. A slot is
    free again once the consumer has moved past its chunk: the compute
    stream records an event there, the copy stream waits on it before the
    device buffer is overwritten, and the worker waits for the slot's
    last copy to complete before it refills the staging buffer. The
    yielded tensors are the slot's device buffers, valid until the
    consumer takes the next chunk. ``prefetch=0`` runs the same steps
    serially in the consumer's thread; the results are bit-identical.

    On the CPU the feed yields plain padded slices: no pinning, no
    streams, no thread.

    With ``timer`` (an ``EventTimer``) every copy is recorded as an
    ``h2d`` span on the copy stream, and two waits as spans on the
    compute stream: ``feed_wait``, the consumer's wait for a filled slot
    (in the serial feed, the filling itself), and ``copy_wait``, the
    compute stream's wait for the slot's copy to land."""

    def __init__(self, x_host, vis_host, chunk_size: int, dtype: torch.dtype,
                 device: torch.device, prefetch: int = 2, timer=None):
        self.x = x_host
        self.vis = vis_host
        self.chunk = chunk_size
        self.npts = x_host.shape[0]
        self.nf = x_host.shape[1]
        self.n_chunks = -(-self.npts // chunk_size)
        self.np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.device = device
        self.prefetch = max(0, prefetch)
        self.timer = timer
        if device.type != "cuda":
            return
        shapes = ((chunk_size, self.nf, 2), (chunk_size, 1 if vis_host is None else self.nf))
        n_slots = self.prefetch + 1
        self._staging = [[torch.empty(s, dtype=dtype, pin_memory=True) for s in shapes]
                         for _ in range(n_slots)]
        self._dev = [[torch.empty(s, dtype=dtype, device=device) for s in shapes]
                     for _ in range(n_slots)]
        self._copied = [torch.cuda.Event() for _ in range(n_slots)]
        self._released = [torch.cuda.Event() for _ in range(n_slots)]
        self._copy_stream = torch.cuda.Stream(device)

    def _fill(self, i: int, x_dst: np.ndarray, vis_dst: np.ndarray) -> tuple[int, int]:
        """Slice, pad and cast chunk i into the (C, F, 2) / (C, F|1) arrays."""
        lo = i * self.chunk
        hi = min(lo + self.chunk, self.npts)
        n = hi - lo
        x_dst[:n] = self.x[lo:hi]
        x_dst[n:] = 0
        vis_dst[:n] = 1 if self.vis is None else self.vis[lo:hi]
        vis_dst[n:] = 0
        return lo, hi

    def _cpu_chunks(self):
        for i in range(self.n_chunks):
            x_c = np.empty((self.chunk, self.nf, 2), self.np_dtype)
            vis_c = np.empty((self.chunk, 1 if self.vis is None else self.nf), self.np_dtype)
            lo, hi = self._fill(i, x_c, vis_c)
            yield lo, hi, torch.from_numpy(x_c), torch.from_numpy(vis_c)

    def _stage(self, i: int, slot: int) -> tuple[int, int, int]:
        """Fill slot's staging buffer with chunk i and start its copy."""
        self._copied[slot].synchronize()  # the slot's previous copy has landed
        stage, dev = self._staging[slot], self._dev[slot]
        lo, hi = self._fill(i, stage[0].numpy(), stage[1].numpy())
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._released[slot])  # the consumer is done with it
            with span(self.timer, "h2d"):
                for d, s in zip(dev, stage):
                    d.copy_(s, non_blocking=True)
            self._copied[slot].record(self._copy_stream)
        return lo, hi, slot

    def __iter__(self):
        if self.device.type != "cuda":
            yield from self._cpu_chunks()
            return
        compute = torch.cuda.current_stream(self.device)
        n_slots = self.prefetch + 1

        def consume(item):
            lo, hi, slot = item
            with span(self.timer, "copy_wait"):
                compute.wait_event(self._copied[slot])
            return lo, hi, *self._dev[slot]

        if self.prefetch == 0:
            for i in range(self.n_chunks):
                with span(self.timer, "feed_wait"):
                    item = self._stage(i, 0)
                yield consume(item)
                self._released[0].record(compute)
            return

        ready: queue.Queue = queue.Queue()
        free: queue.Queue = queue.Queue()
        for slot in range(n_slots):
            free.put(slot)
        stop = threading.Event()

        def worker():
            try:
                for i in range(self.n_chunks):
                    slot = None
                    while slot is None:
                        if stop.is_set():
                            return
                        try:
                            slot = free.get(timeout=0.05)
                        except queue.Empty:
                            pass
                    ready.put(self._stage(i, slot))
            except BaseException as exc:  # surface worker failures to the consumer
                ready.put(exc)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            for _ in range(self.n_chunks):
                with span(self.timer, "feed_wait"):
                    item = ready.get()
                if isinstance(item, BaseException):
                    raise item
                yield consume(item)
                self._released[item[2]].record(compute)
                free.put(item[2])
        finally:
            stop.set()
            th.join()


def bundle_adjust_streamed(
    x_host,
    init_X,
    init_K,
    init_R,
    init_t,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    chunk_size: int = 16384,
    init_c: float | None = None,
    prefetch: int = 2,
    distortion=None,
    device=None,
    timer=None,
) -> BAResult:
    """Bundle adjustment whose observations stream from host memory.

    ``x_host`` (P, F, 2) and ``visibility`` (P, F) are NumPy arrays (or
    anything ``np.asarray`` takes) and are never moved to the card whole.
    The camera state, X (P, 3) and the (9F, 9F) system live on the card
    (``device``, default the CUDA card; ``device="cpu"`` runs the plain
    versions on the CPU). The working dtype is x_host's, where the JAX
    package takes it from its x64 flag.

    The protocol is the JAX package's streamed one: the reference damping
    schedule only (``config.damping`` is not read), ``c /= divisor`` on
    accept and ``c *= scale_factor`` on reject, a trial accepted when its
    error is finite and not above the current one, at most
    ``max_inner_retries`` tries per iteration, and a stop after an
    iteration that accepted nothing or moved E by at most ``delta_tol``.
    The host reads the error once per segment and the trial error once
    per retry. Under a robust loss (IRLS) the retry's baseline is the
    weighted E at the current state from pass 1, read with the trial
    error, and the returned E is the weighted one. ``init_c`` resumes the damping (the returned ``log["c"]``
    carries the final value), so segmented runs match continuous ones.

    ``prefetch``: chunks copied ahead of the computation (0 = serial);
    the results are identical either way. ``timer`` (an ``EventTimer``)
    records ``pass1``, ``pass2``, ``k1`` (each K1 product with its fold
    into the sum) and the feed's ``h2d``, ``feed_wait`` and ``copy_wait``
    spans on the card.

    ``distortion`` / ``config.distortion_rounds``: any distortion family,
    held fixed or alternated with its refit as in the dense core; each
    refit pass's terms are summed over one streaming pass. ``n_iter`` and
    ``n_solver_retries`` count every LM segment. An unknown loss or model
    name raises ``ValueError``."""
    dev = resolve_device(device)
    x_host = np.asarray(x_host)
    dt = result_dtype(x_host)
    vis_host = None if visibility is None else np.asarray(visibility)
    npts, nf = x_host.shape[0], x_host.shape[1]

    X0, R0, t0, info = normalize_gauge(
        as_tensor(init_X, dev, dt), as_tensor(init_R, dev, dt), as_tensor(init_t, dev, dt), axis
    )
    f_in, u_in = intrinsics_from_K(as_tensor(init_K, dev, dt), f0)
    no_points = torch.zeros((0, 3), dtype=dt, device=dev)
    cam = BAState(X=no_points, f=f_in, u=u_in, t=t0, R=R0)
    X_dev = X0  # (P, 3) on the card
    free = gauge_mask(nf, axis, dt, dev)
    feed = _ChunkFeed(x_host, vis_host, chunk_size, dt, dev, prefetch=prefetch, timer=timer)
    nf9 = 9 * nf
    dist, model = _prepare_distortion(distortion, config, nf, 0, dt, dev)
    robust_kind = resolve_robust(config.robust)
    huber_delta = None if robust_kind is None else config.huber_delta

    def zeros_accs():
        return (
            torch.zeros((nf9, nf9), dtype=dt, device=dev),
            torch.zeros((nf9,), dtype=dt, device=dev),
            torch.zeros((nf, 9, 9), dtype=dt, device=dev),
            torch.zeros((nf9,), dtype=dt, device=dev),
            torch.zeros((), dtype=dt, device=dev),
        )

    def get_X_chunk(X_s, lo, hi):
        if hi - lo == feed.chunk:
            return X_s[lo:hi]
        return torch.cat([X_s[lo:hi], X_s.new_zeros((feed.chunk - (hi - lo), 3))])

    def error_of(cam_s, X_s, dist):
        e = torch.zeros((), dtype=dt, device=dev)
        for lo, hi, x_c, vis_c in feed:
            e = e + _chunk_error(cam_s, get_X_chunk(X_s, lo, hi), x_c, vis_c, f0, dist, model)
        return e

    def fit_distortion_streamed(cam_s, X_s, dist):
        """The refit from ``dist``, each pass's terms summed over one
        streaming pass and IRLS-weighted by ``dist``'s residuals."""
        cur = dist
        for round_ in _refit_rounds(model):
            terms = torch.zeros((nf, distortion_nterms(model)), dtype=dt, device=dev)
            for lo, hi, x_c, vis_c in feed:
                terms = terms + _chunk_distortion_terms(
                    cam_s, get_X_chunk(X_s, lo, hi), x_c, vis_c, f0, dist, model, huber_delta,
                    robust_kind, cur, round_)
            cur = _refit_solve(terms, cur, model, round_, config.distortion_shared)
        return cur

    def lm_segment(cam, X_dev, c, max_iter, dist):
        """The LM outer/retry protocol over streamed chunks."""
        e_prev = float(error_of(cam, X_dev, dist))
        n_iter = 0
        n_retries = 0
        for _ in range(max_iter):
            accepted = False
            tries = 0
            e_base = e_prev
            e_new = e_prev
            while not accepted and tries < config.max_inner_retries:
                tries += 1
                n_retries += 1
                # pass 1: accumulate the damped reduced system over chunks
                with span(timer, "pass1"):
                    accs = zeros_accs()
                    for lo, hi, x_c, vis_c in feed:
                        accs = _accumulate_chunk(accs, cam, get_X_chunk(X_dev, lo, hi), x_c,
                                                 vis_c, free, c, f0, huber_delta, robust_kind,
                                                 dist, model, timer)
                    delta_xi, e_w = _assemble_and_solve(accs, free, c)
                    del accs
                trial_cam = _apply_update(cam, delta_xi, no_points)

                # pass 2: back-substitute point updates + trial error
                with span(timer, "pass2"):
                    X_parts = []
                    e_trial = torch.zeros((), dtype=dt, device=dev)
                    for lo, hi, x_c, vis_c in feed:
                        X_new_c, e_c, _, _ = _chunk_backsub(
                            cam, trial_cam, get_X_chunk(X_dev, lo, hi), x_c, vis_c, free, c,
                            delta_xi, f0, huber_delta, robust_kind, dist, model)
                        X_parts.append(X_new_c[: hi - lo])
                        e_trial = e_trial + e_c
                # the one host read of the retry
                e_trial, e_w = torch.stack([e_trial, e_w]).tolist()
                if huber_delta is not None:
                    e_base = e_w  # the weighted E at the current state

                if e_trial <= e_base and np.isfinite(e_trial):
                    accepted = True
                    cam = trial_cam
                    X_dev = torch.cat(X_parts, dim=0)
                    e_new = e_trial
                    c = c / config.divisor
                else:
                    e_new = e_base
                    c = c * config.scale_factor
                del X_parts
            n_iter += 1
            delta = abs(e_new - e_base)
            e_prev = e_new
            if not accepted or delta <= config.delta_tol:
                break
        return cam, X_dev, e_prev, c, n_iter, n_retries

    c = float(config.init_damping if init_c is None else init_c)
    n_iter = n_retries = 0
    for _ in range(config.distortion_rounds):
        # refit first, then an LM segment, as the dense core
        dist = fit_distortion_streamed(cam, X_dev, dist)
        cam, X_dev, _, c, n_seg, r_seg = lm_segment(cam, X_dev, c, config.max_iter, dist)
        n_iter += n_seg
        n_retries += r_seg
    cam, X_dev, e_prev, c, n_seg, r_seg = lm_segment(cam, X_dev, c, config.max_iter, dist)

    Xg, Rg, tg = restore_gauge(info, X_dev, cam.R, cam.t)
    return BAResult(
        X=Xg, K=build_K(cam.f, cam.u, f0), R=Rg, t=tg,
        error=torch.tensor(e_prev, dtype=dt, device=dev), n_iter=n_iter + n_seg,
        log={"n_solver_retries": n_retries + r_seg, "c": c}, distortion=dist,
    )

