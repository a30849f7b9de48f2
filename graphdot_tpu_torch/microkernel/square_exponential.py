"""Square-exponential (Gaussian/RBF) microkernel."""
import numpy as np

from ._base import MicroKernel

SquareExponential = MicroKernel.from_sympy(
    'SquareExponential',

    r"""Gaussian similarity on scalar features: decays smoothly from 1
    toward 0 with the squared distance between the inputs,
    :math:`k(x, y) = \exp(-\frac{(x - y)^2}{2\sigma^2})`.""",

    'exp(-0.5 * (x - y)**2 * length_scale**-2)',

    ('x', 'y'),

    ('length_scale', np.float32, 1e-6, np.inf,
     r"""Distance scale of the decay: the kernel falls to ~0.61 at one
     length scale and is negligible (~0.01) beyond three."""),

    minmax=(0, 1)
)
