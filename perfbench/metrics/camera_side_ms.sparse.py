"""camera_side_ms.sparse: the sparse core's "camera_side" spans (CUDA
events: the damped camera system, its preconditioner and right-hand
side, once a retry, inside the second "build"), their mean in ms."""


def read(run):
    spans = run.spans.get("camera_side")
    return sum(spans) / len(spans) if spans else None
