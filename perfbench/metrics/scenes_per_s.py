"""scenes_per_s: scenes reconstructed (calibration and BA) in the window's
whole batches over the window's seconds (host clock)."""


def read(run):
    return run.work / run.window_s if run.window_s > 0 else None
