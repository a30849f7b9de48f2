"""Host-side helpers: the per-phase :class:`Timer`, hyperparameter trees
(:mod:`.pretty_tuple`, :mod:`.iterable`) and the per-graph cache
(:mod:`.cookie`). A copy of the parts of :mod:`graphdot_tpu.util` that the
port uses."""
import time

_UNITS = {'s': 1.0, 'ms': 1e3, 'us': 1e6, 'ns': 1e9}


class Timer:
    """Tag-based tic/toc timer for per-phase wall-clock reports.

    Repeated tic/toc cycles on the same tag accumulate, so a phase inside
    a loop reports its total.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._open = {}
        self._elapsed = {}

    def tic(self, tag):
        self._open[tag] = time.perf_counter()

    def toc(self, tag):
        delta = time.perf_counter() - self._open.pop(tag)
        self._elapsed[tag] = self._elapsed.get(tag, 0.0) + delta

    @property
    def dt(self):
        """Accumulated durations by tag (seconds)."""
        return dict(self._elapsed)

    def report(self, unit='s'):
        try:
            scale = _UNITS[unit]
        except KeyError:
            raise ValueError(f'Unknown unit {unit}')
        for tag, elapsed in self._elapsed.items():
            print(f'{elapsed * scale:9.1f} {unit} on {tag}')
