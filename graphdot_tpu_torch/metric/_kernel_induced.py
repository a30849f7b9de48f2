"""Kernel-induced distance; a copy of
``graphdot_tpu/metric/_kernel_induced.py`` (host logic, numpy).

The RKHS distance d(x, y) = sqrt(k(x,x)/2 + k(y,y)/2 - k(x,y)) with
chain-rule gradients through the kernel's hyperparameters, over any kernel
that returns numpy arrays. What differs from the original: ``device``,
the device of the kernel it wraps (for ``KernelOverMetric``).
"""
import numpy as np


class KernelInducedDistance:
    r"""The kernel-induced distance
    :math:`d(x, y) = \sqrt{\frac{1}{2}(k(x, x) + k(y, y)) - k(x, y)}`.

    Parameters
    ----------
    kernel: callable
        A positive semidefinite kernel.
    kernel_options: dict
        Additional arguments forwarded to the kernel.
    """

    # the 1/2 factor is fractionally reduced and the gradient denominator
    # nudged so that both stay finite at coincident points (mirrors the
    # reference's stability tweaks)
    _half = 0.4999997
    _eps = 1e-4

    def __init__(self, kernel, kernel_options={}):
        self.kernel = kernel
        self.kernel_options = kernel_options

    def _pieces(self, X, Y, jac):
        """(k12, k1, k2) and, when jac, their hyperparameter jacobians."""
        opts = self.kernel_options
        if Y is None:
            if jac:
                k12, dk12 = self.kernel(X, eval_gradient=True, **opts)
                diag_idx = np.diag_indices_from(k12)
                return (k12, k12.diagonal().copy(), k12.diagonal().copy(),
                        dk12, dk12[diag_idx].copy(), dk12[diag_idx].copy())
            k12 = self.kernel(X, **opts)
            return k12, k12.diagonal().copy(), k12.diagonal().copy()
        if jac:
            k12, dk12 = self.kernel(X, Y, eval_gradient=True, **opts)
            k1, dk1 = self.kernel.diag(X, True, **opts)
            k2, dk2 = self.kernel.diag(Y, True, **opts)
            return k12, k1, k2, dk12, dk1, dk2
        return (self.kernel(X, Y, **opts),
                self.kernel.diag(X, **opts), self.kernel.diag(Y, **opts))

    def __call__(self, X, Y=None, eval_gradient=False):
        """The distance matrix, optionally with its gradient w.r.t. the
        (linear-scale) hyperparameters."""
        if eval_gradient:
            k12, k1, k2, dk12, dk1, dk2 = self._pieces(X, Y, jac=True)
        else:
            k12, k1, k2 = self._pieces(X, Y, jac=False)

        squared = (
            self._half * (k1[:, None] + k2[None, :]) - k12
        )
        distance = np.sqrt(np.clip(squared, 0.0, None))
        if not eval_gradient:
            return distance

        d_squared = (
            0.5 * (dk1[:, None, :] + dk2[None, :, :]) - dk12
        )
        # d sqrt(s) = ds / (2 sqrt(s)), regularized near zero distance
        gradient = d_squared * (
            0.5 / (distance + self._eps)
        )[..., None]
        return distance, gradient

    @property
    def device(self):
        """The wrapped kernel's device (that of the kernel a wrapper such
        as ``Normalization`` holds), or None."""
        kernel = self.kernel
        while not hasattr(kernel, 'device') and hasattr(kernel, 'kernel'):
            kernel = kernel.kernel
        return getattr(kernel, 'device', None)

    @property
    def hyperparameters(self):
        return self.kernel.hyperparameters

    @property
    def theta(self):
        return self.kernel.theta

    @theta.setter
    def theta(self, value):
        self.kernel.theta = value

    @property
    def bounds(self):
        return self.kernel.bounds

    def clone_with_theta(self, theta=None):
        return type(self)(
            self.kernel.clone_with_theta(
                self.theta if theta is None else theta),
            self.kernel_options)
