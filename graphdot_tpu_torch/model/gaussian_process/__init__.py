"""Gaussian process regression over graph kernels; counterpart of
``graphdot_tpu/model/gaussian_process``.

:class:`GaussianProcessRegressor` accepts any kernel with the sklearn-style
graph-kernel protocol, most notably
``Normalization(MarginalizedGraphKernel(...))``, whose fit runs its Gram
and jacobian through a ``GramFactory`` on the kernel's device.
``LowRankApproximateGPR`` and ``GPROutlierDetector`` are still to port.
"""
from .gpr import GaussianProcessRegressor

__all__ = ['GaussianProcessRegressor']
