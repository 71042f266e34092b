"""point_side_ms.sparse: the sparse core's "point_side" spans (CUDA
events: the point blocks, the point gradient and the weighted E, once an
LM iteration, inside the first "build"), their mean in ms."""


def read(run):
    spans = run.spans.get("point_side")
    return sum(spans) / len(spans) if spans else None
