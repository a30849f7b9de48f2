"""Device milliseconds a request of the operations launched inside the
program's ``mlgk_setup_edge`` spans (inside ``mlgk_setup``: the edge
kernel's values and T = w1 w2 k_edge, which scale with m1 m2), from the
profiler's trace."""
from h100_bench.spans import per_request

UNIT = 'ms'
RANGE = 'mlgk_setup_edge'


def read(run):
    if run.trace is None:
        return None
    return per_request(run, run.trace.device_s_in(RANGE))
