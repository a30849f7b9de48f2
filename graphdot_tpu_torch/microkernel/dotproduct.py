"""Inner-product microkernel on vector-valued features; counterpart of
``graphdot_tpu/microkernel/dotproduct.py``."""
import numpy as np
import torch

from ._base import MicroKernel


def DotProduct():
    r"""Plain inner product :math:`k(x, y) = \langle x, y \rangle` on
    vector features. Has no hyperparameters."""

    class DotProductKernel(MicroKernel):

        @property
        def name(self):
            return 'DotProduct'

        def __repr__(self):
            return f'{self.name}()'

        def __call__(self, X, Y, jac=False):
            value = np.asarray(X) @ np.asarray(Y)
            return (value, np.array([])) if jac is True else value

        @property
        def n_theta(self):
            return 0

        def apply(self, theta, X, Y):
            # variable-length features arrive as (values, mask) with a
            # trailing padded axis; padding is zero, so a plain
            # contraction is exact
            vx, _ = X
            vy, _ = Y
            return torch.sum(vx * vy, dim=-1)

        @property
        def theta(self):
            return tuple()

        @theta.setter
        def theta(self, seq):
            pass

        @property
        def bounds(self):
            return tuple()

        @property
        def minmax(self):
            return (0, np.inf)

    return DotProductKernel()
