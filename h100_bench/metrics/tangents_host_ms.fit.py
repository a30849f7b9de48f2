"""Host milliseconds an evaluation inside the program's ``mlgk_tangents``
ranges (the tangent set-up: ``torch.func.jacfwd`` of the system set-up and
the tangents' right-hand sides), from the profiler's trace."""
UNIT = 'ms'
RANGE = 'mlgk_tangents'


def read(run):
    done = run.done()
    if run.trace is None or not done:
        return None
    host_s = run.trace.host_s_in(RANGE)
    return 1e3 * host_s / len(done) if host_s else None
