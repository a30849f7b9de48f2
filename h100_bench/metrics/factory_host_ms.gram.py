"""Host milliseconds a request of the self time of the program's
``normalization``, ``mlgk_call``, ``gram_factory`` and ``mlgk_chunk``
spans: their host time less that of every span nested in them (the set-up,
the solves, the host's waits), from the profiler's trace."""
from h100_bench.spans import host_s_less, per_request

UNIT = 'ms'
RANGES = ('normalization', 'mlgk_call', 'gram_factory', 'mlgk_chunk')


def read(run):
    if run.trace is None:
        return None
    return per_request(run, host_s_less(run.trace, RANGES))
