"""feed_wait_ms.streamed: the streamed feed's "feed_wait" spans (CUDA
events on the compute stream around the consumer's wait for a filled
slot) summed over the window, in ms a retry."""


def read(run):
    spans, retries = run.spans.get("feed_wait"), run.counts.get("retries")
    return sum(spans) / retries if spans and retries else None
