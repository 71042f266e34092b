"""Device busy time, kernel totals and idle gaps from a ``torch.profiler``
run, read in memory (no trace file is written).

The profiler records CPU and CUDA activity over the traced span, which the
harness marks with the user annotation ``WINDOW``. Device activity is
every CUDA event that is an operation (kernels, copies, sets), not the
device-side copies of the host's annotations; busy time is the length of
their union inside the span. An idle gap is a stretch of the span with no
device activity; it is named by the host event that had started last
before its middle (``after_`` when that event had already ended).
"""

from __future__ import annotations

import bisect
import re

WINDOW = "perfbench.window"


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)[:64]


def _annotation(e) -> bool:
    kind = getattr(e, "activity_type", None)  # not in every torch version
    return e.is_user_annotation() or (kind is not None and "user_annotation" in str(kind()))


def summarize(prof, top: int = 10) -> dict:
    """{busy_s, window_s, device_ops, idle_gaps} of a finished profile."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ws = we = None
    host, dev, marks = [], [], set()
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            if e.name() == WINDOW:
                ws, we = e.start_ns(), e.end_ns()
            else:
                host.append((e.start_ns(), e.end_ns(), e.name()))
            if _annotation(e):
                marks.add(e.name())
        elif not _annotation(e):
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    if ws is None:
        raise RuntimeError("the profile holds no window annotation")
    per_op: dict[str, float] = {}
    spans = []
    for s, t, name in dev:
        s, t = max(s, ws), min(t, we)
        if t <= s or name in marks or name == WINDOW:
            continue
        per_op[name] = per_op.get(name, 0.0) + (t - s) / 1e9
        spans.append((s, t))
    spans.sort()
    busy = 0
    gaps = []
    cur_s = cur_t = ws
    for s, t in spans:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    if we > cur_t:
        gaps.append((cur_t, we))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    named = []
    for g0, g1 in gaps[:top]:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0:
            label = "no_host_event"
        else:
            s, t, name = host[i]
            label = _short(name if t >= mid else "after_" + name)
        named.append([label, (g1 - g0) / 1e9])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy / 1e9, "window_s": (we - ws) / 1e9,
            "device_ops": [[_short(n), v] for n, v in ops], "idle_gaps": named}
