"""Trace capture, named spans and stage timers.

Counterpart of ``mvrecon_tpu/runtime/profiling.py``. ``trace_span`` names
a range in a profiler trace and ``capture_trace`` records one
(``torch.profiler`` in place of ``jax.profiler``). ``StageTimer``'s stage
wall is taken between two device synchronizations, so it holds the device
work the stage queued. ``EventTimer`` records spans of device time with
CUDA events and reads them after the run, so a timed loop gains no
synchronization.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range in the profiler trace (``torch.profiler.record_function``),
    so that a trace shows the calibration, factorization and BA stages."""
    with torch.profiler.record_function(name):
        yield


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
    adds up its walls."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        start = time.perf_counter()
        with trace_span(name):
            yield
        self._sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - start


class EventTimer:
    """Named spans of device time on the card. Each span is a pair of CUDA
    events recorded on the calling thread's current stream; ``ms`` waits
    for the card once and returns every span's milliseconds by name."""

    def __init__(self):
        self._spans: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._spans.setdefault(name, []).append((start, end))

    def ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._spans.items()}
