"""Wall-clock stage timer.

Counterpart of ``StageTimer`` in ``mvrecon_tpu/runtime/profiling.py``. A
stage's wall is taken between two device synchronizations, so it holds
the device work the stage queued.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


class StageTimer:
    """Host wall per named stage, synchronized with the card when one is
    in use."""

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
        self.times[name] = time.perf_counter() - start
