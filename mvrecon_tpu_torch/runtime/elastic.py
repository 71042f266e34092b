"""Host-side retries and crash-resumable segmented runs.

Counterpart of ``mvrecon_tpu/runtime/elastic.py``:

- :func:`run_with_retries` re-runs a flaky call a bounded number of times;
- :func:`resumable_bundle_adjust` (the chunked core) and
  :func:`resumable_bundle_adjust_sparse` (the observation-list core) run
  BA in segments and checkpoint the whole state after each (X, K, R, t,
  the damping c and nu, the iterations done). Re-invoked after a crash,
  they continue from the checkpoint. Segmented runs equal a continuous one,
  because the damping carries over through ``init_c``/``init_nu`` and the
  gauge round trip is the identity.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ..config import LMConfig, as_numpy
from .checkpoint import checkpoint_backend


def run_with_retries(
    fn: Callable,
    max_attempts: int = 3,
    retry_on: tuple = (RuntimeError,),
    backoff_s: float = 1.0,
    on_retry: Callable[[int, Exception], None] | None = None,
):
    """Call ``fn()``; on an exception in ``retry_on`` wait and call again,
    up to ``max_attempts`` calls in all (waits of ``backoff_s`` doubling).
    Raises the last error if every attempt fails."""
    last = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt + 1 < max_attempts:
                time.sleep(backoff_s * (2**attempt))
    raise last


def _segmented(run_segment, init_X, init_K, init_R, init_t, checkpoint_path: str,
               total_iters: int, segment_iters: int, config: LMConfig, backend: str,
               stop_on_converged: bool, on_segment=None):
    """The segment loop shared by both resumable drivers: resume from the
    checkpoint when it exists, run segments of ``segment_iters`` through
    ``run_segment(state, seg_cfg)`` and checkpoint after each. Returns (the
    last result, iterations run in this process)."""
    if config.distortion_rounds > 0:
        raise ValueError("the resumable drivers do not take the distortion refit "
                         "alternation (distortion_rounds > 0): its refits would move with "
                         "the segment boundaries. Pass a fixed `distortion` instead.")
    save_ckpt, load_ckpt, ckpt_exists = checkpoint_backend(backend)
    state = {k: as_numpy(a) for k, a in zip("XKRt", (init_X, init_K, init_R, init_t))}
    state.update(c=np.asarray(config.init_damping, np.float64), nu=np.asarray(2.0, np.float64))
    done = 0
    if ckpt_exists(checkpoint_path):
        state, step = load_ckpt(checkpoint_path, state)
        done = int(step or 0)
    ran_here = 0
    res = None
    while done < total_iters:
        seg = min(segment_iters, total_iters - done)
        res = run_segment(state, dataclasses.replace(config, max_iter=seg))
        n = int(res.n_iter)
        ran_here += n
        done += n
        state = {k: as_numpy(a) for k, a in zip("XKRt", (res.X, res.K, res.R, res.t))}
        state.update({k: np.asarray(as_numpy(res.log[k]), np.float64) for k in ("c", "nu")})
        save_ckpt(checkpoint_path, state, step=done)
        if on_segment is not None:
            on_segment(done, res)
        # a segment that stopped early converged or never accepted; the
        # sparse core also says so when the stop falls on its last iteration
        if n < seg or (stop_on_converged and bool(res.log["converged"])):
            break
    return res, ran_here


def resumable_bundle_adjust(
    x,
    init_X,
    init_K,
    init_R,
    init_t,
    checkpoint_path: str,
    total_iters: int,
    segment_iters: int = 5,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    chunk_size: int = 768,
    backend: str = "npz",
    distortion=None,
    device=None,
):
    """The chunked core (``bundle_adjust_chunked``) in checkpointed
    segments; safe to kill and re-invoke. If ``checkpoint_path`` exists the
    run resumes from its (X, K, R, t, c, nu, iterations) instead of
    ``init_*``. ``distortion`` is a fixed model applied in every segment
    (the caller passes the same one again on re-invocation); the refit
    alternation raises ``ValueError``. Returns (the last segment's
    ``BAResult``, iterations run in this process)."""
    from ..models.bundle_adjustment_chunked import bundle_adjust_chunked

    def run_segment(state, cfg):
        return bundle_adjust_chunked(x, state["X"], state["K"], state["R"], state["t"], f0=f0,
                                     visibility=visibility, axis=axis, config=cfg,
                                     chunk_size=chunk_size, init_c=state["c"],
                                     init_nu=state["nu"], distortion=distortion, device=device)

    return _segmented(run_segment, init_X, init_K, init_R, init_t, checkpoint_path, total_iters,
                      segment_iters, config, backend, stop_on_converged=False)


def resumable_bundle_adjust_sparse(
    obs,
    init_X,
    init_K,
    init_R,
    init_t,
    checkpoint_path: str,
    total_iters: int,
    segment_iters: int = 1,
    f0: float = 1.0,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    backend: str = "npz",
    distortion=None,
    factor_dtype=None,
    matvec_chunk: int | None = None,
    factor_mode: str = "stored",
    on_segment=None,
    device=None,
):
    """The observation-list core (``bundle_adjust_sparse``) in checkpointed
    segments, with :func:`resumable_bundle_adjust`'s contract. It stops on
    the core's ``converged`` flag: a segment that converges on its last
    iteration has run all of its iterations, and going on past convergence
    lets near-undamped IRLS steps walk the state away.
    ``on_segment(done, res)`` is called after each segment."""
    from ..models.bundle_adjustment_sparse import bundle_adjust_sparse

    def run_segment(state, cfg):
        return bundle_adjust_sparse(obs, state["X"], state["K"], state["R"], state["t"], f0=f0,
                                    axis=axis, config=cfg, cg_tol=cg_tol,
                                    cg_max_iter=cg_max_iter, obs_chunk=obs_chunk,
                                    init_c=state["c"], init_nu=state["nu"],
                                    distortion=distortion, factor_dtype=factor_dtype,
                                    matvec_chunk=matvec_chunk, factor_mode=factor_mode,
                                    device=device)

    return _segmented(run_segment, init_X, init_K, init_R, init_t, checkpoint_path, total_iters,
                      segment_iters, config, backend, stop_on_converged=True,
                      on_segment=on_segment)
