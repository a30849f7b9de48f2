"""Product-reduced multi-feature kernel."""
from .composite import Composite


def TensorProduct(**kw_kernels):
    r"""Multiplies per-feature microkernels:
    :math:`k(X, Y) = \prod_a k_a(X_a, Y_a)`. Shorthand for
    ``Composite('*', **kw_kernels)``."""
    return Composite('*', **kw_kernels)
