"""Log marginal likelihood evaluations (value and gradient) completed in
the window, over the window's seconds (host clock)."""
UNIT = 'evals/s'


def read(run):
    done = [r['record'] for r in run.done() if 'evals' in r['record']]
    if not done or run.window_s <= 0:
        return None
    return sum(r['evals'] for r in done) / run.window_s
