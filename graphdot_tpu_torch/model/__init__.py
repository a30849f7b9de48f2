"""Models on graph kernels; counterpart of ``graphdot_tpu/model``:
Gaussian processes (:mod:`.gaussian_process`), Gaussian fields
(:mod:`.gaussian_field`) and active learning (:mod:`.active_learning`).
The JAX package's tree search has no counterpart here yet."""
from .gaussian_process import (
    GaussianProcessRegressor,
    GPROutlierDetector,
    LowRankApproximateGPR,
)

__all__ = [
    'GaussianProcessRegressor', 'LowRankApproximateGPR',
    'GPROutlierDetector'
]
