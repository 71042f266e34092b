"""cg_iters.sparse: PCG iterations a solve, from the core's log
(cg_iters_total), over the window's solves."""


def read(run):
    n = run.counts.get("cg_iters")
    return n / run.work if n is not None and run.work else None
