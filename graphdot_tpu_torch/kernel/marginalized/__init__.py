"""Marginalized graph kernel on torch tensors."""
from ._kernel import MarginalizedGraphKernel
from .starting_probability import Adhoc, StartingProbability, Uniform

__all__ = [
    'MarginalizedGraphKernel', 'StartingProbability', 'Uniform', 'Adhoc'
]
