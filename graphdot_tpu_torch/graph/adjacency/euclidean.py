"""Shape functions mapping interatomic distance to edge weight; a copy of
``graphdot_tpu/graph/adjacency/euclidean.py`` (numpy only).

Each shape is a callable ``w(d, length_scale)`` decaying with distance,
paired with a ``cutoff`` beyond which the weight is (treated as) zero.
``d`` may be a scalar or an ndarray of distances.
"""
import numpy as np

_SUPPORT_SIGMAS = 3.0


class _CompactShape:
    """Common machinery for shapes supported on ``[0, 3 * length_scale)``:
    subclasses define ``_profile(s)`` on the rescaled coordinate
    ``s = 1 - d / cutoff`` and get masking + vectorization for free."""

    def cutoff(self, length_scale):
        return _SUPPORT_SIGMAS * length_scale

    def __call__(self, d, length_scale):
        s = 1.0 - np.asarray(d, dtype=float) / self.cutoff(length_scale)
        inside = s >= 0
        w = np.where(inside, self._profile(np.where(inside, s, 0.0)), 0.0)
        return w if w.ndim else w.item()


class Gaussian:
    """w = exp(-d^2 / 2 sigma^2); infinite support."""

    def __call__(self, d, length_scale):
        z = np.asarray(d, dtype=float) / length_scale
        w = np.exp(-0.5 * z * z)
        return w if w.ndim else w.item()

    def cutoff(self, length_scale):
        return np.inf


class Tent(_CompactShape):
    """w = max(0, 1 - d/(3 sigma))^n; compact support at 3 sigma."""

    def __init__(self, ord):
        if ord < 1:
            raise ValueError(f'Tent order must be >= 1, got {ord}.')
        self.ord = ord

    def _profile(self, s):
        return s ** self.ord


class CompactBell(_CompactShape):
    """A smooth compactly-supported bell
    w = (a s^b - b s^a) / (a - b) with s = max(0, 1 - d/(3 sigma)),
    requiring a > b >= 2 so that w and w' vanish at the cutoff."""

    def __init__(self, a, b):
        if not (a > b >= 2):
            raise ValueError(f'CompactBell needs a > b >= 2, got {a=} {b=}.')
        self.a = a
        self.b = b

    def _profile(self, s):
        a, b = self.a, self.b
        return (a * s ** b - b * s ** a) / (a - b)
