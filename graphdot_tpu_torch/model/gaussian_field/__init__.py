"""Semi-supervised Gaussian field models on graphs; counterpart of
``graphdot_tpu/model/gaussian_field``."""
from .gfr import GaussianFieldRegressor
from .weight import RBFOverDistance, RBFOverFixedDistance, Weight

__all__ = [
    'GaussianFieldRegressor',
    'Weight',
    'RBFOverDistance',
    'RBFOverFixedDistance',
]
