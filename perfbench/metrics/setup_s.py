"""setup_s: process start to the first timed unit (host clock): the draw
of the inputs from the seed, the kernel build in a new checkout, the
warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
