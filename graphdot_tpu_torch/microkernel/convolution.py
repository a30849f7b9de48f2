"""Convolutional microkernel over variable-length features; counterpart of
``graphdot_tpu/microkernel/convolution.py``."""
import numpy as np
import torch

from ..util.pretty_tuple import pretty_tuple
from ._base import MicroKernel, _safe_div


def Convolution(kernel, mean=True):
    r"""Averages (or sums) evaluations of a base microkernel between all
    pairs of elements of two variable-length feature sequences:
    :math:`k_{conv}(X, Y) = \frac{\sum_{x \in X}\sum_{y \in Y}
    k_{base}(x, y)}{|X||Y|}` (mean=True) or the plain double sum
    (mean=False).
    """

    class ConvolutionOf(MicroKernel):

        @property
        def name(self):
            return 'Convolution'

        def __init__(self, kernel, mean):
            self.kernel = kernel
            self.mean = mean

        def __call__(self, X, Y, jac=False):
            reduce = np.mean if self.mean else np.sum
            if not jac:
                return reduce(
                    [self.kernel(x, y) for x in X for y in Y])
            pairs = [self.kernel(x, y, jac=True) for x in X for y in Y]
            values = reduce([f for f, _ in pairs])
            grads = reduce([df for _, df in pairs], axis=0)
            return values, grads

        def __repr__(self):
            return f'{self.name}({repr(self.kernel)})'

        @property
        def n_theta(self):
            return self.kernel.n_theta

        def apply(self, theta, X, Y):
            # (values, mask) with a trailing padded axis: the base kernel
            # on the outer grid of the two sequences, masked and summed
            vx, mx = X
            vy, my = Y
            k = self.kernel.apply(theta, vx[..., :, None], vy[..., None, :])
            m = mx[..., :, None] * my[..., None, :]
            s = torch.sum(k * m, dim=(-2, -1))
            if self.mean:
                return _safe_div(s, torch.sum(m, dim=(-2, -1)))
            return s

        @property
        def theta(self):
            return pretty_tuple(self.name, ['base'])(self.kernel.theta)

        @theta.setter
        def theta(self, seq):
            self.kernel.theta = seq[0]

        @property
        def bounds(self):
            return (self.kernel.bounds,)

        @property
        def minmax(self):
            return self.kernel.minmax

    return ConvolutionOf(kernel, mean=mean)
