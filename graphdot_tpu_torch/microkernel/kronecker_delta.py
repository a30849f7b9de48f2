"""Kronecker delta microkernel on categorical features."""
import numpy as np
import torch

from ..util.pretty_tuple import pretty_tuple
from ._base import MicroKernel, _column


class _KroneckerDelta(MicroKernel):
    r"""Equality test with a tunable floor: 1 when the two features
    compare equal, ``h`` otherwise.

    Parameters
    ----------
    h: float in (0, 1)
        Baseline similarity between unequal features.
    h_bounds: (lo, hi) or "fixed"
        Training range of ``h`` ("fixed" excludes it from optimization).
    """

    name = 'KroneckerDelta'
    n_theta = 1

    def __init__(self, h, h_bounds=(1e-3, 1)):
        self.h = float(h)
        self.h_bounds = h_bounds
        self._assert_bounds('h', h_bounds)

    def __repr__(self):
        return f'{self.name}({self.h})'

    # host-side scalar semantics + analytic jacobian
    def __call__(self, i, j, jac=False):
        equal = (i == j)
        value = 1.0 if equal else self.h
        if jac is True:
            return value, np.array([0.0 if equal else 1.0])
        return value

    def apply(self, theta, X, Y):
        return torch.where(X == Y, 1.0, theta[0])

    def c_expr(self, theta, X, Y):
        x, y = _column(X), _column(Y)
        if x is None or y is None:
            return None
        return f'({x} == {y} ? 1.0F : {theta[0]})'

    @property
    def theta(self):
        return pretty_tuple(self.name, ['h'])(self.h)

    @theta.setter
    def theta(self, seq):
        self.h = seq[0]

    @property
    def bounds(self):
        return (self.h_bounds,)

    @property
    def minmax(self):
        return (self.h, 1)


def KroneckerDelta(h, h_bounds=(1e-3, 1)):
    """Factory with the signature of
    ``graphdot_tpu.microkernel.KroneckerDelta``."""
    return _KroneckerDelta(h, h_bounds)
