"""kr_eigh_s.batch: the calibration's "kr_eigh" stages (each depth step's
top-eigenvector eigh: the per-image 12 x 12 Khatri-Rao Grams in the
cells' dual low-rank method, between two device synchronizations)
summed over the window's batches, over the batches."""


def read(run):
    s = run.stages.get("kr_eigh")
    return s / run.units if s is not None and run.units else None
