"""Share of the pairs whose edge coupling T the program built in one pass
of its ``setup_edge`` kernel, over the traced window: the program's counter
``setup_edge.fused`` over ``setup_edge.pairs`` (every pair that reached
T's build), in percent. None on a program without the counters."""
from h100_bench.spans import counter_ratio

UNIT = '%'


def read(run):
    if run.trace is None:
        return None
    try:
        share = counter_ratio('setup_edge.fused', 'setup_edge.pairs')
    except KeyError:        # pairs counted, none of them in one pass
        return 0.0
    return None if share is None else 100 * share
