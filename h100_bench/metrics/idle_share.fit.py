"""The device's idle share of the traced window, in percent: 1 minus the
union of the intervals of its operations (kernels, copies, sets) over the
window's length, from the profiler's trace."""
UNIT = '%'


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
