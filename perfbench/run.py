"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
the correctness check compared, with its limit); the checks are also the
last lines of standard error. The run needs as many CUDA devices as the
cell asks for and exits with another code than 0, printing no result,
when they are missing or when the process holds JAX or the JAX package
after the window. ``--device cpu --toy`` runs the cell at the traffic's
toy sizes on the CPU (the tests).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "perfbench_cache" / sub))
# the package is imported from the root; the script's own folder is not a
# path (its module names would shadow the standard library's)
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != Path(__file__).resolve().parent]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--toy", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    wl = harness.cell_spec(args.workload)[0]
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {args.workload} needs {wl['chips']} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 2
    result, lines = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                                    args.device, args.toy, T_START, chips=wl["chips"])
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run holds {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
