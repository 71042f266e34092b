"""host_wait_ms.sparse: the sparse core's "host_read" spans (CUDA events
on the compute stream on both sides of each blocking read: PCG's
convergence flag every few iterations, its count, the retry's decision)
summed over the window, in ms a solve: the time the stream sat idle
behind the host's reads."""


def read(run):
    spans = run.spans.get("host_read")
    return sum(spans) / run.work if spans and run.work else None
