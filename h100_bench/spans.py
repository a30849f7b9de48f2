"""Host time of the program's spans, and its counters, as the per-layer
metrics read them from a traced window.

:func:`host_s_less` sums the host time of nested spans by name, less the
spans nested in them; :func:`counter_ratio` reads the program's counters
(``graphdot_tpu_torch.util.trace``), which count only while the profiler
records, so over the traced window alone. Where the program has no such
span or counter, both return 0 or None and raise nothing.
"""


def host_s_less(trace, names, minus=None):
    """Host seconds inside the outermost ranges of ``trace`` (a
    :class:`h100_bench.tracing.Trace`) named in ``names``, less the
    outermost ranges nested in them named in ``minus`` (None: every range
    not named in ``names``, so that the result is the self time of the
    named ranges)."""
    names = set(names)
    total = 0
    # (end, inside a named range, inside a subtracted one), outermost first
    stack = []
    for name, start, end in sorted(trace.ranges, key=lambda r: (r[1], -r[2])):
        while stack and not (start >= stack[-1][0] and end <= stack[-1][1]):
            stack.pop()
        inside, taken = stack[-1][2:] if stack else (False, False)
        if not inside:
            if name in names:
                total += end - start
                inside = True
        elif not taken and (name not in names if minus is None
                            else name in minus):
            total -= end - start
            taken = True
        stack.append((start, end, inside, taken))
    return total / 1e9


def counter_ratio(steps, systems):
    """The program's counter ``steps`` over its counter ``systems``; None
    where the program keeps no counters or counted no systems."""
    try:
        from graphdot_tpu_torch.util.trace import counters
    except ImportError:
        return None
    c = counters()
    return c[steps] / c[systems] if c.get(systems) else None


def per_request(run, seconds):
    """Milliseconds a finished request of ``seconds``; None where the run
    has no trace, no finished request or no such time."""
    done = run.done()
    if run.trace is None or not done or not seconds:
        return None
    return 1e3 * seconds / len(done)
