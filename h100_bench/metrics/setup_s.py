"""Seconds from the start of the process until the window opens (host
clock): imports, the inputs made from the seed, the program's graphs,
kernels and plans, any kernel build, and the warm-up of the cell's
shapes."""
UNIT = 's'


def read(run):
    return run.setup_s
