"""Launches of the program's solve kernels a request over the window, from
the wrappers' ``.launches`` counters (``pcg_resident``, ``pcg_cluster``,
``pcg_stream``, ``pcg_packed``, ``kron_pcg``)."""
UNIT = 'count'


def read(run):
    done = run.done()
    if run.trace is None or not done:
        return None
    return sum(run.counters.values()) / len(done)
