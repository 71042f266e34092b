"""Stage and span timers.

``StageTimer`` is the counterpart of ``StageTimer`` in
``mvrecon_tpu/runtime/profiling.py``: a stage's wall is taken between two
device synchronizations, so it holds the device work the stage queued.
``EventTimer`` records spans of device time with CUDA events and reads
them after the run, so a timed loop gains no synchronization.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


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
        with torch.profiler.record_function(name):
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
