"""build_ms.sparse: the sparse core's "build" spans (CUDA events: the
factor rows and point side once an iteration, the camera side each retry)
summed over the window, over the window's retries."""


def read(run):
    spans, retries = run.spans.get("build"), run.counts.get("retries")
    return sum(spans) / retries if spans and retries else None
