"""Models on graph kernels; counterpart of ``graphdot_tpu/model``. Only the
exact Gaussian-process regressor is ported so far."""
from .gaussian_process import GaussianProcessRegressor

__all__ = ['GaussianProcessRegressor']
