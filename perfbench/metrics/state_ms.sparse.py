"""state_ms.sparse: the sparse core's "state" spans (CUDA events: the
factor rows of the whole list at the iteration's state, once an LM
iteration, inside the first "build"), their mean in ms."""


def read(run):
    spans = run.spans.get("state")
    return sum(spans) / len(spans) if spans else None
