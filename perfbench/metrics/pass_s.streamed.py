"""pass_s.streamed: the streamed core's pass 1 and pass 2 spans (CUDA
events on the compute stream) summed over the window, in seconds a
retry."""


def read(run):
    p1, p2 = run.spans.get("pass1"), run.spans.get("pass2")
    retries = run.counts.get("retries")
    if not p1 or not p2 or not retries:
        return None
    return (sum(p1) + sum(p2)) / 1e3 / retries
