"""Host milliseconds a request inside the program's PCG wrapper spans
(``pcg_resident_call``, ``pcg_cluster_call``, ``pcg_packed_call``,
``pcg_stream_call``, ``kron_pcg_call``: their checks, plans and launches),
less the ``host_sync`` spans nested in them, from the profiler's trace."""
from h100_bench.spans import host_s_less, per_request

UNIT = 'ms'
RANGES = ('pcg_resident_call', 'pcg_cluster_call', 'pcg_packed_call',
          'pcg_stream_call', 'kron_pcg_call')


def read(run):
    if run.trace is None:
        return None
    return per_request(run, host_s_less(run.trace, RANGES, ('host_sync',)))
