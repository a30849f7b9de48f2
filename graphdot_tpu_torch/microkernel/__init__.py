"""Node- and edge-level base kernels ("microkernels") on torch tensors.

Counterpart of :mod:`graphdot_tpu.microkernel`: each microkernel is a
host-side scalar callable with analytic jacobians and a vectorized
``apply(theta, X, Y)`` on tensors, consumed by the product-graph solver.
"""
from ._base import Constant, MicroKernel, Normalize
from .additive import Additive
from .composite import Composite
from .convolution import Convolution
from .dotproduct import DotProduct
from .kronecker_delta import KroneckerDelta
from .product import Product
from .rational_quadratic import RationalQuadratic
from .square_exponential import SquareExponential
from .tensor_product import TensorProduct

__all__ = [
    'MicroKernel',
    'Constant',
    'Normalize',
    'Product',
    'KroneckerDelta',
    'SquareExponential',
    'RationalQuadratic',
    'Composite',
    'TensorProduct',
    'Additive',
    'Convolution',
    'DotProduct',
]
