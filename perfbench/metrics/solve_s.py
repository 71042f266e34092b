"""solve_s: the window's seconds over the whole solves completed in it
(host clock; the window closes at the end of the first unit that ends
after --seconds)."""


def read(run):
    return run.window_s / run.work if run.work else None
