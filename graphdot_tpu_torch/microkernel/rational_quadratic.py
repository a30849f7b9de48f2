"""Rational-quadratic microkernel; counterpart of
``graphdot_tpu/microkernel/rational_quadratic.py`` (the same expression,
bounds and range)."""
import numpy as np

from ._base import MicroKernel

RationalQuadratic = MicroKernel.from_sympy(
    'RationalQuadratic',

    r"""A scale mixture of square-exponential kernels:
    :math:`k(x, y) = (1 + \frac{(x-y)^2}{2\alpha\ell^2})^{-\alpha}`.
    Small alpha mixes in long length scales; as alpha grows the kernel
    approaches a single square exponential of scale ell.""",

    '(1 + (x - y)**2 / (2 * alpha * length_scale**2))**(-alpha)',

    ('x', 'y'),

    ('length_scale', np.float32, 1e-6, np.inf,
     r"""The smallest constituent length scale."""),
    ('alpha', np.float32, 1e-3, np.inf,
     r"""Mixture concentration: larger values suppress the long-length-
     scale components faster."""),

    minmax=(0, 1)
)
