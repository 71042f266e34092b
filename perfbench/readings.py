"""Readings for the correctness limits, in one process per cell.

    python3 perfbench/readings.py --workload <name> --sound <seed>... --control <seed>...

For each ``--sound`` seed: one unit of the program at the cell's own size,
judged as a run judges it. For each ``--control`` seed: the reference in
the program's place in the next lower precision (TF32 products), judged
the same way; the control must fail a check. ``--sweep key=v1,v2,...``
instead runs the cell's window (traced) once for each value of one
traffic key. Prints one JSON line per reading. Not run by the benchmark's
own runs.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--sweep", default=None)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--toy", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    _, cfg, traffic, _ = harness.cell_spec(args.workload)
    traffic = harness.scaled(traffic, args.toy)
    dev = torch.device(args.device)
    kind = harness.kind_module(traffic)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    if args.sweep:
        key, vals = args.sweep.split("=")
        for v in vals.split(","):
            t = {**traffic, key: json.loads(v)}
            res, _ = harness.execute(args.workload, args.sound[0] if args.sound else 1,
                                     args.seconds, True, args.device, traffic=t)
            emit({"sweep": {key: t[key]}, **res})
            torch.cuda.empty_cache()
        return 0
    for seed in args.sound:
        t0 = time.perf_counter()
        cell = kind.Cell(cfg, traffic, seed, dev)
        t1 = time.perf_counter()
        cell.unit()
        harness.sync(dev)
        t2 = time.perf_counter()
        checks = cell.judge(random.Random(seed))
        emit({"sound": seed, "checks": checks, "readings": cell.readings,
              "setup_s": t1 - t0, "unit_s": t2 - t1,
              "judge_s": time.perf_counter() - t2, "counts": cell.counts})
        del cell
        torch.cuda.empty_cache()
    for seed in args.control:
        cell = kind.Cell(cfg, traffic, seed, dev)
        t1 = time.perf_counter()
        rng = random.Random(seed)
        if hasattr(cell, "sample"):
            idx = cell.sample(rng)
            checks = cell.judge_scenes(idx, cell.control_answer(idx))
        else:
            checks = cell.judge(rng, cell.control_answer())
        emit({"control": seed, "checks": checks, "readings": cell.readings,
              "s": time.perf_counter() - t1})
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
