"""k1_ms.streamed: the streamed core's "k1" spans (CUDA events: each K1
product of pass 1 with its mirror and its fold into the Schur sum, timed
inside the program), their mean in ms a launch."""


def read(run):
    spans = run.spans.get("k1")
    return sum(spans) / len(spans) if spans else None
