"""Graph kernels and kernel wrappers."""
from .fix import Exponentiation, Normalization
from .marginalized import MarginalizedGraphKernel
from .molecular import Tang2019MolecularKernel

__all__ = [
    'MarginalizedGraphKernel', 'Tang2019MolecularKernel',
    'Normalization', 'Exponentiation'
]
