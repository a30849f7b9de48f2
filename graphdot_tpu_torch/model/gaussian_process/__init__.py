"""Gaussian process regression over graph kernels; counterpart of
``graphdot_tpu/model/gaussian_process``.

Three variants: exact GPR (:class:`GaussianProcessRegressor`), the
Nystrom low-rank approximation for large datasets
(:class:`LowRankApproximateGPR`), and maximum-likelihood per-sample noise
estimation for outlier detection (:class:`GPROutlierDetector`). All of
them accept any kernel with the sklearn-style graph-kernel protocol, most
notably ``Normalization(MarginalizedGraphKernel(...))``, and run their
linear algebra in float64 on their ``device``, the card unless the caller
asks for the CPU.
"""
from .gpr import GaussianProcessRegressor
from .nystrom import LowRankApproximateGPR
from .outlier_detector import GPROutlierDetector

__all__ = [
    'GaussianProcessRegressor',
    'LowRankApproximateGPR',
    'GPROutlierDetector',
]
