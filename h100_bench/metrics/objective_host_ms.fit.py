"""Host milliseconds an evaluation inside the program's ``gp_objective``
spans (the likelihood and its gradient around the Gram: regularization,
copies to the card, the float64 linear algebra), less the ``gram_factory``
and ``host_sync`` spans nested in them, from the profiler's trace."""
from h100_bench.spans import host_s_less, per_request

UNIT = 'ms'
RANGES = ('gp_objective',)


def read(run):
    if run.trace is None:
        return None
    return per_request(run, host_s_less(run.trace, RANGES,
                                        ('gram_factory', 'host_sync')))
