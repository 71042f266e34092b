#!/usr/bin/env python3
"""Time the two candidate designs of the sparse core's segment sums on the
card, at chip_smoke phase 4u's layout: 1M points x 1,600 cameras, each
point seen by 10 consecutive cameras from a random start (10M
observations, sorted by point).

- camera side, 9 rows (the CG matvec's F^T w): (a) the port's design, a
  stable camera sort planned once, then a gather into camera order and a
  sorted segment sum (``bundle_adjustment_sparse._cam_sum``, row by row
  over long segments); (a') the same sums as one k-row ``segment_reduce``
  call; (b) ``index_add_`` along the observations;
- point side, 3 rows (F v): (a) one k-row sorted ``segment_reduce``
  (``_seg_sum``); (a') row by row; (b) ``index_add_``.

Each is timed by CUDA events (median of ``--reps`` after a warm-up) and
run twice more to see whether its float32 result repeats bit for bit.
Prints one JSON line with the card's name and power limit. Run from the
repository root: ``python3 scripts/sparse_reductions.py``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--cams", type=int, default=1600)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sparse_reductions: no CUDA device", file=sys.stderr)
        return 2
    from mvrecon_tpu_torch.models import bundle_adjustment_sparse as tbs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    npts, nf, win = args.points, args.cams, args.window
    lo = torch.randint(0, nf - win + 1, (npts,), generator=gen, device=dev, dtype=torch.int32)
    pi = torch.arange(npts, device=dev, dtype=torch.int32).repeat_interleave(win)
    ci = (lo[:, None] + torch.arange(win, device=dev, dtype=torch.int32)).reshape(-1)
    n = pi.shape[0]
    obs = tbs.SparseObs(pi, ci, torch.zeros((2, n), device=dev), torch.ones(n, device=dev))
    torch.cuda.synchronize()
    plan = tbs._plan(obs, nf, n)[0]
    rows9 = torch.randn((9, n), generator=gen, device=dev)
    rows3 = torch.randn((3, n), generator=gen, device=dev)
    ci64, pi64 = ci.long(), pi.long()

    def cam_sorted():
        return tbs._cam_sum(rows9, plan)

    def cam_one_call():
        g = rows9.index_select(1, plan.c_perm)
        return torch.segment_reduce(g, "sum", offsets=plan.c_off.expand(9, nf + 1), axis=1)

    def cam_index_add():
        return torch.zeros((9, nf), device=dev).index_add_(1, ci, rows9)

    def pt_sorted():
        return tbs._seg_sum(rows3, plan.p_off)

    def pt_rows():
        return torch.stack([torch.segment_reduce(r, "sum", offsets=plan.p_off) for r in rows3])

    def pt_index_add():
        return torch.zeros((3, npts), device=dev).index_add_(1, pi, rows3)

    def time_ms(fn):
        fn()
        ts = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    ref_c = torch.zeros((9, nf), dtype=torch.float64, device=dev).index_add_(
        1, ci64, rows9.double())
    ref_p = torch.zeros((3, npts), dtype=torch.float64, device=dev).index_add_(
        1, pi64, rows3.double())
    out = {}
    for name, fn, ref in (("camera_9_rows_sorted", cam_sorted, ref_c),
                          ("camera_9_rows_sorted_one_call", cam_one_call, ref_c),
                          ("camera_9_rows_index_add", cam_index_add, ref_c),
                          ("point_3_rows_sorted", pt_sorted, ref_p),
                          ("point_3_rows_sorted_by_row", pt_rows, ref_p),
                          ("point_3_rows_index_add", pt_index_add, ref_p)):
        a, b = fn(), fn()
        out[name] = {"ms": time_ms(fn), "repeats_bitwise": bool(torch.equal(a, b)),
                     "max_rel_err_vs_float64": float((a.double() - ref).abs().max()
                                                     / ref.abs().max())}
    out["plan_ms"] = time_ms(lambda: tbs._plan(obs, nf, n))
    out["gather_9_rows_camera_order_ms"] = time_ms(lambda: rows9.index_select(1, plan.c_perm))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "points": npts, "cams": nf, "observations": n,
                      "torch": torch.__version__, "cuda": torch.version.cuda, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
