"""copy_wait_ms.streamed: the streamed feed's "copy_wait" spans (CUDA
events on the compute stream on both sides of its wait for a slot's copy
to land) summed over the window, in ms a retry."""


def read(run):
    spans, retries = run.spans.get("copy_wait"), run.counts.get("retries")
    return sum(spans) / retries if spans and retries else None
