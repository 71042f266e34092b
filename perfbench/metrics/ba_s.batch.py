"""ba_s.batch: the BA stage's wall (between two device synchronizations,
the pipeline's stage timer) summed over the window's batches, over the
batches."""


def read(run):
    s = run.stages.get("bundle_adjustment")
    return s / run.units if s is not None and run.units else None
