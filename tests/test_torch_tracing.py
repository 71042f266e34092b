"""The port's spans and stages (``runtime/profiling.py``) on the CPU, at
toy sizes, with the program's own ``EventTimer`` on its host clock:

- the sparse core records ``state`` and ``point_side`` once an LM
  iteration, ``camera_side`` once a retry, ``build`` around both, at least
  two ``host_read`` spans a retry, and no ``cg`` or ``trial``;
- the streamed core records ``pass1`` and ``pass2`` once a retry and
  ``k1`` once a chunk of pass 1 (the feed's ``h2d``, ``feed_wait`` and
  ``copy_wait`` exist on the card only);
- the calibration records the stages ``projective_depths``, ``kr_eigh``
  and ``subspace_eigh``, each within the whole calibration, on a
  ``StageTimer(nested=True)``; a default ``StageTimer`` times only the
  outermost stages and leaves the inner ones as profiler ranges;
- results are bit-identical with and without a timer;
- ``span(None, ...)`` is one shared no-op that makes no CUDA event and no
  profiler range;
- under ``torch.profiler`` a timed sparse solve's spans are ranges of the
  same trace;
- the benchmark's readers of these spans (``perfbench/metrics/``) find
  what the program records.
"""

import importlib.util
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from mvrecon_tpu_torch.config import LMConfig
from mvrecon_tpu_torch.geometry.scenes import make_synthetic_scene
from mvrecon_tpu_torch.models.bundle_adjustment_sparse import (
    bundle_adjust_sparse,
    dense_to_sparse_obs,
)
from mvrecon_tpu_torch.models.bundle_adjustment_streamed import bundle_adjust_streamed
from mvrecon_tpu_torch.models.perspective import perspective_self_calibration
from mvrecon_tpu_torch.runtime import profiling
from mvrecon_tpu_torch.runtime.profiling import EventTimer, StageTimer, span, stage

AXIS = "x-up_z-forward"
METRICS = Path(__file__).resolve().parents[1] / "perfbench" / "metrics"
SPARSE_CFG = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=4, init_damping=3e-3,
                      damping="nielsen")
STREAMED_CFG = LMConfig(scale_factor=2.0, delta_tol=1e-10, max_iter=3, init_damping=1e-4)
CHUNK = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=3, n_images=8):
    """The curved tube, observations (P, F, 2) as numpy, X and t moved by
    0.02 N(0, 1): (x, X0, K, R, t0)."""
    sc = make_synthetic_scene(torch.Generator().manual_seed(seed), n_images=n_images,
                              noise=0.003, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    X0 = sc.X.numpy() + 0.02 * rng.standard_normal(tuple(sc.X.shape))
    t0 = sc.t.numpy() + 0.02 * rng.standard_normal(tuple(sc.t.shape))
    return (np.ascontiguousarray(sc.x.transpose(0, 1).numpy()), X0, sc.K.numpy(),
            sc.R.numpy(), t0)


def _sparse(timer=None):
    x, X0, K, R, t0 = _scene()
    vis = (np.random.default_rng(0).random(x.shape[:2]) < 0.6).astype(np.float64)
    obs = dense_to_sparse_obs(x, vis, device="cpu")
    return bundle_adjust_sparse(obs, X0, K, R, t0, axis=AXIS, config=SPARSE_CFG, cg_tol=1e-6,
                                cg_max_iter=50, device="cpu", timer=timer)


def _streamed(prefetch, timer=None):
    x, X0, K, R, t0 = _scene(seed=5)
    return bundle_adjust_streamed(x, X0, K, R, t0, axis=AXIS, config=STREAMED_CFG,
                                  chunk_size=CHUNK, prefetch=prefetch, device="cpu",
                                  timer=timer)


def _calibrate(method, eig_method, timer=None):
    x = torch.stack([make_synthetic_scene(torch.Generator().manual_seed(s), n_images=6,
                                          dtype=torch.float64).x for s in (1, 2)])
    return perspective_self_calibration(x, tol=1e-2, method=method, eig_method=eig_method,
                                        device="cpu", timer=timer)


def _same(a, b):
    for name in ("X", "K", "R", "t", "error"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert a.n_iter == b.n_iter


@pytest.fixture(scope="module")
def sparse_timed():
    timer = EventTimer("cpu")
    return _sparse(timer), timer.ms()


@pytest.fixture(scope="module")
def streamed_timed():
    timer = EventTimer("cpu")
    return _streamed(2, timer), timer.ms()


@pytest.fixture(scope="module")
def calibration_timed():
    timer = StageTimer(nested=True)
    start = time.perf_counter()
    res = _calibrate("dual", "lowrank", timer)
    return res, timer.times, time.perf_counter() - start


def test_span_without_a_timer_is_one_shared_no_op():
    ctx = span(None, "state")
    assert ctx is span(None, "host_read") is profiling._NOOP
    with ctx:
        pass
    with ctx:  # the shared context enters again
        pass


def test_event_timer_times_the_host_off_the_card():
    timer = EventTimer("cpu")
    with span(timer, "outer"):
        with span(timer, "inner"):
            time.sleep(0.01)
    ms = timer.ms()
    assert not timer.cuda and set(ms) == {"outer", "inner"}
    assert 10.0 <= ms["inner"][0] <= ms["outer"][0]


def test_untimed_cores_make_no_event_and_no_range(monkeypatch):
    """With no timer the sparse and streamed cores never build a CUDA event
    or a profiler range: every span site is the shared no-op."""

    def forbidden(*a, **k):
        raise AssertionError("an untimed span made an event or a range")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert np.isfinite(float(_sparse().error))
    assert np.isfinite(float(_streamed(2).error))


def test_sparse_spans_count_iterations_and_retries(sparse_timed):
    res, ms = sparse_timed
    n_iter, retries = res.n_iter, res.log["n_solver_retries"]
    assert n_iter >= 2 and retries >= n_iter
    assert len(ms["state"]) == len(ms["point_side"]) == n_iter
    assert len(ms["camera_side"]) == retries
    assert len(ms["build"]) == n_iter + retries
    assert len(ms["host_read"]) >= 2 * retries
    assert len(ms["matvec"]) >= res.log["cg_iters_total"]
    assert not {"cg", "trial"} & set(ms)
    # the three parts lie inside the build spans
    parts = sum(sum(ms[k]) for k in ("state", "point_side", "camera_side"))
    assert parts <= sum(ms["build"])


def test_sparse_results_do_not_depend_on_the_timer(sparse_timed):
    res, _ = sparse_timed
    plain = _sparse()
    _same(res, plain)
    assert res.log["cg_iters_total"] == plain.log["cg_iters_total"]
    assert res.log["n_solver_retries"] == plain.log["n_solver_retries"]


def test_streamed_spans(streamed_timed):
    res, ms = streamed_timed
    retries = res.log["n_solver_retries"]
    n_chunks = -(-200 // CHUNK)
    assert len(ms["pass1"]) == len(ms["pass2"]) == retries
    assert len(ms["k1"]) == n_chunks * retries
    assert sum(ms["k1"]) <= sum(ms["pass1"])
    # the CPU feed hands out plain slices: no copy, no wait
    assert not {"h2d", "feed_wait", "copy_wait"} & set(ms)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_streamed_results_do_not_depend_on_the_timer(streamed_timed, prefetch):
    timed = streamed_timed[0] if prefetch == 2 else _streamed(prefetch, EventTimer("cpu"))
    _same(timed, _streamed(prefetch))


def test_calibration_stages(calibration_timed):
    res, times, whole = calibration_timed
    assert {"projective_depths", "kr_eigh", "subspace_eigh"} <= set(times)
    for name in ("projective_depths", "kr_eigh", "subspace_eigh"):
        assert 0.0 < times[name] <= whole, name
    assert times["kr_eigh"] + times["subspace_eigh"] <= whole


@pytest.mark.parametrize("method,eig_method", [("dual", "lowrank"), ("primary", "eigh")])
def test_calibration_results_do_not_depend_on_the_timer(calibration_timed, method, eig_method):
    if method == "dual":
        timed = calibration_timed[0]
    else:
        timer = StageTimer(nested=True)
        timed = _calibrate(method, eig_method, timer)
        assert {"projective_depths", "kr_eigh"} <= set(timer.times)
    plain = _calibrate(method, eig_method)
    for name in ("X", "R", "t", "K", "depth_error", "depth_iters", "status"):
        assert torch.equal(getattr(timed, name), getattr(plain, name)), name


def test_stage_without_a_timer_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with stage(None, "untimed_stage"):
            torch.ones(4).sum()
    assert "untimed_stage" in {e.name for e in prof.events()}


@pytest.mark.parametrize("nested", [False, True])
def test_stage_timer_times_inner_stages_only_when_nested(nested):
    """By default a stage inside another is a profiler range alone, so the
    walls are the outermost stages'; ``nested=True`` times it too."""
    timer = StageTimer(nested=nested)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("outer"):
            with stage(timer, "inner"):
                time.sleep(0.005)
    assert "inner" in {e.name for e in prof.events()}
    assert set(timer.times) == ({"outer", "inner"} if nested else {"outer"})
    assert timer.times["outer"] >= timer.times.get("inner", 0.0) >= (0.005 if nested else 0.0)
    assert timer._depth == 0


def test_spans_are_ranges_of_the_profiler_trace():
    """A timed sparse solve under the profiler: its spans are ranges on the
    profiler's clock, beside the operators they cover."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _sparse(EventTimer("cpu"))
    names = {e.name for e in prof.events()}
    assert {"build", "state", "point_side", "camera_side", "host_read", "matvec"} <= names


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_benchmark_readers_find_the_program_spans(sparse_timed, streamed_timed,
                                                  calibration_timed):
    """Each reader of the new spans reads a number from a window of the
    program's own timer; the feed's readers read nothing on the CPU."""
    res, ms = sparse_timed
    run = types.SimpleNamespace(spans=ms, stages={}, units=1, work=1, cell=None,
                                counts={"retries": res.log["n_solver_retries"]})
    for name in ("state_ms.sparse", "point_side_ms.sparse", "camera_side_ms.sparse",
                 "host_wait_ms.sparse"):
        assert _reader(name)(run) > 0, name
    assert _reader("camera_side_ms.sparse")(run) == pytest.approx(
        sum(ms["camera_side"]) / len(ms["camera_side"]))
    res, ms = streamed_timed
    run = types.SimpleNamespace(spans=ms, stages={}, units=1, work=1,
                                counts={"retries": res.log["n_solver_retries"]},
                                cell=types.SimpleNamespace(kw={"chunk_size": CHUNK}, n_cams=8,
                                                           x_host=np.zeros(1)))
    assert _reader("k1_ms.streamed")(run) > 0
    for name in ("feed_wait_ms.streamed", "copy_wait_ms.streamed", "h2d_gbps.streamed"):
        assert _reader(name)(run) is None, name
    run.spans = dict(ms, h2d=[2.0, 2.0])
    per_copy = CHUNK * (8 * 2 + 1) * 8
    assert _reader("h2d_gbps.streamed")(run) == pytest.approx(2 * per_copy / 1e9 / 4e-3)
    _, times, _ = calibration_timed
    run = types.SimpleNamespace(spans={}, stages=times, units=2, work=2, counts={}, cell=None)
    for name, stage_name in (("depths_s.batch", "projective_depths"),
                             ("kr_eigh_s.batch", "kr_eigh"),
                             ("subspace_eigh_s.batch", "subspace_eigh")):
        assert _reader(name)(run) == pytest.approx(times[stage_name] / 2), name
