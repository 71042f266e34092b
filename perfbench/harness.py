"""The benchmark's harness: one run of one cell.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration (a file of
``configs/``) and a traffic mix (``traffic/<name>.json``). The mix names
its kind, a module of ``kinds/`` that draws the inputs from the seed, runs
one unit of work through the program and judges the answers with the plain
reference. Every metric is a reader of its own, ``metrics/<name>.py``, so
a cell or a metric is added with files and entries alone.

The window: the first unit starts it; it closes at the end of the first
unit that ends after ``--seconds``; every unit restarts from the same
start state, drawn at set-up. Rates count those whole units over the
whole window.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from . import devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mvrecon_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (``mvrecon_tpu_torch`` is not ``mvrecon_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(workload: str, bench: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic, BENCHMARK.json) of a cell."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, traffic, bench


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell prints: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a metric without ``workloads``
    belongs to every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_module(traffic: dict):
    return importlib.import_module(f"perfbench.kinds.{traffic['kind']}")


def scaled(traffic: dict, toy: bool) -> dict:
    """The traffic, or its ``toy`` sizes for the CPU tests."""
    return {**traffic, **traffic.get("toy", {})} if toy else traffic


class EventSpans:
    """Named spans of device time: CUDA events on the card (read once,
    after the window), host time on the CPU. The program's cores take it
    as their ``timer``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._spans: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if self.cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self._spans.setdefault(name, []).append((a, b))

    def ms(self) -> dict[str, list[float]]:
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._spans.items()}
        return {k: [(b - a) * 1e3 for a, b in v] for k, v in self._spans.items()}


class StageClock:
    """Host wall of each named stage between two device synchronizations,
    added up over the window: the ``timer`` of the program's pipelines."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            torch.cuda.synchronize()
        a = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        if self.cuda:
            torch.cuda.synchronize()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - a


class Run:
    """What the metric readers read: the window, the work done in it, the
    spans, stages and counts the instruments gathered, and the profile."""

    def __init__(self, cell, seconds: float):
        self.cell = cell
        self.seconds = seconds
        self.window_s = 0.0
        self.units = 0
        self.work = 0
        self.setup_s = 0.0
        self.peak_bytes = 0
        self.spans: dict[str, list[float]] = {}
        self.stages: dict[str, float] = {}
        self.counts: dict[str, float] = {}
        self.shapes: dict[str, list] = {}
        self.trace: dict | None = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def trace_unit(cell, run: Run, device: torch.device) -> None:
    """Profile one more unit of the cell after the window (CPU and CUDA
    activity, read in memory): the traced span of a ``--trace 1`` run. It
    follows the window, so neither the profiler nor what it leaves behind
    slows the window; its answers are not judged."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kept = len(cell.answers)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            cell.unit()
            sync(device)
    del cell.answers[kept:]
    t_read = time.perf_counter()
    run.trace = devtrace.summarize(prof)
    log(f"traced one unit: {run.trace['window_s']:.3f} s, read in "
        f"{time.perf_counter() - t_read:.3f} s")


def measure(cell, run: Run, device: torch.device) -> None:
    """The window: units until one ends after ``run.seconds``."""
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    while True:
        run.work += cell.unit()
        sync(device)
        run.units += 1
        if time.perf_counter() - start >= run.seconds:
            break
    run.window_s = time.perf_counter() - start
    run.peak_bytes = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                      else 0)


def execute(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
            toy: bool = False, t_start: float | None = None, bench: dict | None = None,
            chips: int = 1, traffic: dict | None = None) -> tuple[dict, list[str]]:
    """One run of the cell: (the result line's object, the check lines).
    ``traffic`` replaces the cell's mix (the block sweep)."""
    t_start = time.perf_counter() if t_start is None else t_start
    wl, cfg, own, bench = cell_spec(workload, bench)
    traffic = scaled(traffic or own, toy)
    dev = torch.device(device)
    cell = kind_module(traffic).Cell(cfg, traffic, seed, dev)
    sync(dev)
    log(f"inputs drawn at {time.perf_counter() - t_start:.3f} s")
    run = Run(cell, seconds)
    cell.warm()
    sync(dev)
    run.setup_s = time.perf_counter() - t_start
    log(f"set-up {run.setup_s:.3f} s")
    if traced:
        cell.instrument(run)
    measure(cell, run, dev)
    log(f"window {run.window_s:.3f} s, {run.units} units")
    cell.collect(run)
    if traced:
        trace_unit(cell, run, dev)
    found = forbidden_modules()
    if found:
        raise ImportError(f"the run holds {', '.join(found)} after its window")
    values = {}
    for m in cell_metrics(bench, workload, traced):
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cell.release()
    t_judge = time.perf_counter()
    checks = cell.judge(random.Random(seed))
    log(f"judged in {time.perf_counter() - t_judge:.3f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": correct,
        "attempted": run.work,
        "failed": cell.failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "count": chips,
            "memory_peak_bytes": run.peak_bytes,
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines
