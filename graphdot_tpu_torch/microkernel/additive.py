"""Sum-reduced multi-feature kernel."""
from .composite import Composite


def Additive(**kw_kernels):
    r"""Sums per-feature microkernels:
    :math:`k(X, Y) = \sum_a k_a(X_a, Y_a)`. Shorthand for
    ``Composite('+', **kw_kernels)``."""
    return Composite('+', **kw_kernels)
