"""Models on graph kernels; counterpart of ``graphdot_tpu/model``:
Gaussian processes (:mod:`.gaussian_process`), Gaussian fields
(:mod:`.gaussian_field`), active learning (:mod:`.active_learning`) and
tree search (:mod:`.tree_search`)."""
from .gaussian_process import (
    GaussianProcessRegressor,
    GPROutlierDetector,
    LowRankApproximateGPR,
)

__all__ = [
    'GaussianProcessRegressor', 'LowRankApproximateGPR',
    'GPROutlierDetector'
]
