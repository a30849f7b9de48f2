"""Graph pairs of all Grams completed in the window, over the window's
seconds (host clock): each request's n (n + 1) / 2 pairs. The window runs
from the first request's start to the last one's end, so a rate is taken
over all the work and all the time of the window."""
UNIT = 'pairs/s'


def read(run):
    done = [r['record'] for r in run.done() if 'pairs' in r['record']]
    if not done or run.window_s <= 0:
        return None
    return sum(r['pairs'] for r in done) / run.window_s
