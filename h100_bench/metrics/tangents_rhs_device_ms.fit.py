"""Device milliseconds an evaluation of the operations launched inside the
program's ``mlgk_tangents_rhs`` spans (inside ``mlgk_tangents``: the
tangents' right-hand sides b_d - diag_d x + offdiag(T_d, x), after the
jacobian of the set-up), from the profiler's trace."""
from h100_bench.spans import per_request

UNIT = 'ms'
RANGE = 'mlgk_tangents_rhs'


def read(run):
    if run.trace is None:
        return None
    return per_request(run, run.trace.device_s_in(RANGE))
