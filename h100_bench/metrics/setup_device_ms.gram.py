"""Device milliseconds a request of the operations launched inside the
program's ``mlgk_setup`` ranges (the product-graph systems: Vx, the
diagonal, the preconditioner, b and T), from the profiler's trace."""
UNIT = 'ms'
RANGE = 'mlgk_setup'


def read(run):
    done = run.done()
    if run.trace is None or not done:
        return None
    device_s = run.trace.device_s_in(RANGE)
    return 1e3 * device_s / len(done) if device_s else None
