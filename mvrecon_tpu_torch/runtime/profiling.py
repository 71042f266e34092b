"""Trace capture, named spans and stage timers.

Counterpart of ``mvrecon_tpu/runtime/profiling.py``. ``capture_trace``
records a profiler trace (``torch.profiler`` in place of
``jax.profiler``). The cores and pipelines name their work through two
helpers:

- ``span(timer, name)``: a span of device time in a hot loop. Without a
  timer it is one shared no-op context (no event, no profiler range, no
  allocation); with one it is a ``torch.profiler.record_function`` range
  and the timer's span together, so every program span lies in the same
  profiler trace as the kernels it covers.
- ``stage(timer, name)``: a pipeline stage. Without a timer it is a
  profiler range; with one it is the timer's stage, which synchronizes
  the device at both ends.

``StageTimer``'s stage wall is taken between two device synchronizations,
so it holds the device work the stage queued. ``EventTimer`` records
spans of device time with CUDA events and reads them after the run, so a
timed loop gains no synchronization; off the card it times the host.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

TRACE_FILE = "trace.json"

# the one context every untimed span returns: entering it does nothing
_NOOP = contextlib.nullcontext()


@contextlib.contextmanager
def _timed_span(timer, name: str) -> Iterator[None]:
    with torch.profiler.record_function(name), timer.span(name):
        yield


def span(timer, name: str):
    """A named span: the shared no-op without ``timer``, else a profiler
    range and ``timer.span(name)`` (an ``EventTimer`` or any object with
    the same ``span``)."""
    return _NOOP if timer is None else _timed_span(timer, name)


def stage(timer, name: str):
    """A named pipeline stage: a profiler range without ``timer``, else
    ``timer.stage(name)`` (a ``StageTimer`` or any object with the same
    ``stage``)."""
    return torch.profiler.record_function(name) if timer is None else timer.stage(name)


@contextlib.contextmanager
def capture_trace(log_dir: str) -> Iterator[None]:
    """Profile the block on the host, and on the card when CUDA is in use,
    and write its Chrome/Perfetto trace to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StageTimer:
    """Host wall per named stage, synchronized with the card when one is
    in use. A stage that runs more than once (once per block of scenes)
    adds up its walls.

    A stage opened inside another (the calibration's ``projective_depths``,
    ``kr_eigh`` and ``subspace_eigh`` inside ``perspective_self_calibration``)
    is only a profiler range unless the timer is made with ``nested=True``:
    by default ``times`` holds the outermost stages alone, which add up to
    the run and cost no synchronization inside a stage. With ``nested``
    every stage is timed, and the walls of inner stages lie inside their
    outer stage's."""

    def __init__(self, nested: bool = False):
        self.nested = nested
        self.times: dict[str, float] = {}
        self._depth = 0

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        if self._depth and not self.nested:
            with torch.profiler.record_function(name):
                yield
            return
        self._sync()
        start = time.perf_counter()
        self._depth += 1
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._depth -= 1
        self._sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - start


class EventTimer:
    """Named spans of device time. On the card each span is a pair of CUDA
    events recorded on the calling thread's current stream; ``ms`` waits
    for the card once and returns every span's milliseconds by name. Off
    the card (``device`` a CPU device, or no CUDA at all) a span is the
    host wall between its ends."""

    def __init__(self, device=None):
        self.cuda = (torch.device(device).type == "cuda" if device is not None
                     else torch.cuda.is_available())
        self._spans: dict[str, list[tuple]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._spans.setdefault(name, []).append((start, end))

    def ms(self) -> dict[str, list[float]]:
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._spans.items()}
        return {k: [(b - a) * 1e3 for a, b in v] for k, v in self._spans.items()}
