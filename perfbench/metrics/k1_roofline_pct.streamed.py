"""k1_roofline_pct.streamed: the least time of the K1 calls
(``ops/syrk.syrk_lower``, the packed lower-triangle Y^T Y) over their
CUDA-event time, in percent.

Operations are counted from each call's shape Y (K, N), the same whatever
implements the call: the lower triangle with its diagonal, N (N + 1) / 2
entries of K multiply-adds, 2 operations each, K N (N + 1). The peak is
float32 accuracy on the TF32 tensor cores: the published TF32 rate
divided by the three products that 3xTF32 costs (``peaks.json``), the
convention of the repository's kernel table. Compute-bound: at (49152,
4500) 9.96e11 operations against 0.9 GB."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


def syrk_flops(k_rows: int, n: int) -> float:
    return float(k_rows) * n * (n + 1)


def read(run):
    spans, shapes = run.spans.get("syrk_lower"), run.shapes.get("syrk_lower")
    if not spans or not shapes:
        return None
    flops = sum(syrk_flops(k, n) for k, n in shapes)
    return 100.0 * (flops / PEAKS["float32_on_tf32_flops_per_s"]) / (sum(spans) / 1e3)
