"""Host milliseconds a request inside the program's ``host_sync`` spans
(its blocking reads of device results: the PCG wrappers' index check, the
Gram's and the GP objective's copies to the host), from the profiler's
trace."""
from h100_bench.spans import host_s_less, per_request

UNIT = 'ms'
RANGES = ('host_sync',)


def read(run):
    if run.trace is None:
        return None
    return per_request(run, host_s_less(run.trace, RANGES, ()))
