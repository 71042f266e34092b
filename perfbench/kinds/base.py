"""What every kind of cell shares: the answers kept from the window, the
instruments, and the limits the judgement holds them to."""

from __future__ import annotations

import math

import torch

from ..harness import EventSpans, Run, StageClock, log


class CellBase:
    """A kind of cell: ``__init__`` draws the inputs from the seed on the
    device, ``warm`` runs the cell's shapes once, ``unit`` runs one unit of
    work through the program and returns its count, ``collect`` hands the
    window's counts and spans to the run, ``release`` frees the program's
    state, and ``judge`` compares a sample of the window's answers with the
    reference: {number: {"value", "limit"}}."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg = cfg
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.answers: list = []
        self.counts: dict[str, float] = {}
        self.shapes: dict[str, list] = {}
        self.spans = None
        self.stages = None
        self.failed = 0
        self.readings: dict[str, float] = {}

    def instrument(self, run: Run) -> None:
        self.spans = EventSpans(self.device)
        self.stages = StageClock(self.device)

    def count(self, name: str, value: float) -> None:
        self.counts[name] = self.counts.get(name, 0.0) + value

    def collect(self, run: Run) -> None:
        run.counts.update(self.counts)
        # copies: the traced unit after the window adds to the cell's own
        run.shapes.update({k: list(v) for k, v in self.shapes.items()})
        if self.spans is not None:
            run.spans = self.spans.ms()
            run.stages = dict(self.stages.times)

    def release(self) -> None:
        """Drop everything of the program but the sampled answer."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def limits(self, readings: dict[str, float]) -> dict:
        """The readings that the traffic holds to a limit, each beside it (a
        reading that is not a number fails); the others are logged."""
        lim = self.traffic["limits"]
        self.readings = {k: float(v) for k, v in readings.items()}
        out = {}
        for k, v in self.readings.items():
            if k in lim:
                out[k] = {"value": v if math.isfinite(v) else 1e300, "limit": lim[k]}
            else:
                log(f"reading {k} {v!r} (not held to a limit)")
        return out
