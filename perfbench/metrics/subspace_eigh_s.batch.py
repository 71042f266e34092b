"""subspace_eigh_s.batch: the calibration's "subspace_eigh" stages (the
eigh of the rank-4 subspace Gram, in each depth step and in the
factorization after the loop, between two device synchronizations)
summed over the window's batches, over the batches."""


def read(run):
    s = run.stages.get("subspace_eigh")
    return s / run.units if s is not None and run.units else None
