"""matvec_roofline_pct.sparse: the least time of the sparse core's PCG
matvec over its CUDA-event time, in percent.

The least time is the bytes one matvec must move at the HBM peak
(``peaks.json``). Counted from the shapes, each read or written once: per
observation the 24 float32 factor rows (96 B), the weight (4 B) and the
point and camera indices (2 x 4 B, int32); per point the six rows of the
inverse damped point block (24 B); per camera the damped 9x9 block, the
unseen flag and the gauge mask (4 x (81 + 1 + 9) B), and the camera
vector read and written (2 x 36 B). Memory-bound: 10M observations need
about 1.1 GB, against 3.4e10 operations."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())


def matvec_bytes(n_obs: int, n_points: int, n_cams: int) -> float:
    return 108.0 * n_obs + 24.0 * n_points + (4 * (81 + 1 + 9) + 72.0) * n_cams


def read(run):
    spans = run.spans.get("matvec")
    if not spans:
        return None
    c = run.cell
    least_s = matvec_bytes(c.n_obs, c.n_points, c.n_cams) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least_s * len(spans) / (sum(spans) / 1e3)
