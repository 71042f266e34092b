"""depths_s.batch: the calibration's "projective_depths" stage (the
depth loop with its host read an iteration, between two device
synchronizations) summed over the window's batches, over the batches."""


def read(run):
    s = run.stages.get("projective_depths")
    return s / run.units if s is not None and run.units else None
