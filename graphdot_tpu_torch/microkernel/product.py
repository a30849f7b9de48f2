"""Direct product microkernel; counterpart of
``graphdot_tpu/microkernel/product.py``."""
import numpy as np

from ._base import MicroKernel, _column


class Product(MicroKernel):
    """Direct product between features, :math:`k(x, y) = x y`; used for
    edge weights."""

    name = property(lambda self: 'Product')

    def __call__(self, x1, x2, jac=False):
        value = x1 * x2
        return (value, np.empty(0)) if jac else value

    def __repr__(self):
        return f'{self.name}()'

    n_theta = property(lambda self: 0)
    theta = property(lambda self: tuple())
    bounds = property(lambda self: tuple())
    minmax = property(lambda self: (None, None))

    @theta.setter
    def theta(self, seq):
        pass

    def apply(self, theta, X, Y):
        return X * Y

    def c_expr(self, theta, X, Y):
        x, y = _column(X), _column(Y)
        return None if x is None or y is None else f'({x} * {y})'
