"""Active learning: greedy training-set selection over a kernel matrix;
counterpart of ``graphdot_tpu/model/active_learning`` (numpy copies)."""
from .determinant_maximizer import DeterminantMaximizer
from .hierarchical_drafter import HierarchicalDrafter
from .variance_minimizer import VarianceMinimizer

__all__ = [
    'HierarchicalDrafter', 'DeterminantMaximizer', 'VarianceMinimizer'
]
