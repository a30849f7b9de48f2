"""Gram-level kernel modifiers: cosine normalization and exponentiation
of a whole kernel, with chain-rule gradients at the matrix level.

A copy of ``graphdot_tpu/kernel/fix.py`` (numpy, and a profiler span around
:meth:`Normalization.__call__`); it is copied because importing
:mod:`graphdot_tpu.kernel` loads JAX."""
import copy

import numpy as np

from ..util.pretty_tuple import pretty_tuple
from ..util.trace import spanned


def _cosine(R, ldiag, rdiag):
    """R_ij / sqrt(ldiag_i rdiag_j), plus the two rsqrt vectors."""
    lr = ldiag ** -0.5
    rr = rdiag ** -0.5
    return lr[:, None] * R * rr[None, :], lr, rr


class _Wrapper:
    """Shared sklearn-protocol plumbing for kernel modifiers."""

    def __init__(self, kernel):
        self.kernel = kernel

    @property
    def hyperparameters(self):
        return self.kernel.hyperparameters

    @property
    def hyperparameter_bounds(self):
        return self.kernel.hyperparameter_bounds

    @property
    def theta(self):
        return self.kernel.theta

    @theta.setter
    def theta(self, value):
        self.kernel.theta = value

    @property
    def bounds(self):
        return self.kernel.bounds

    def clone_with_theta(self, theta):
        """A copy at ``theta`` whose wrapped kernel is cloned by its own
        ``clone_with_theta``, so that a graph kernel's clone shares its
        factory cache."""
        twin = copy.copy(self)
        twin.kernel = self.kernel.clone_with_theta(self.kernel.theta)
        twin.theta = theta
        return twin


class Normalization(_Wrapper):
    r"""Cosine-normalizes a kernel:
    :math:`k_n(x, y) = k(x, y) / \sqrt{k(x, x) k(y, y)}`.

    Parameters
    ----------
    kernel: object
        Any kernel with the graph-kernel call signature.
    """

    @spanned('normalization')
    def __call__(self, X, Y=None, eval_gradient=False, **options):
        """Normalized Gram matrix (and its full chain-rule gradient when
        ``eval_gradient``)."""
        if not eval_gradient:
            R = self.kernel(X, Y, **options)
            if Y is None:
                ldiag = rdiag = R.diagonal()
            else:
                ldiag = self.kernel.diag(X, **options)
                rdiag = self.kernel.diag(Y, **options)
            K, _, _ = _cosine(R, ldiag, rdiag)
            return K

        R, dR = self.kernel(X, Y, eval_gradient=True, **options)
        if Y is None:
            ldiag = rdiag = R.diagonal()
            idx = np.diag_indices_from(R)
            ldDiag = rdDiag = dR[idx]
        else:
            ldiag, ldDiag = self.kernel.diag(X, True, **options)
            rdiag, rdDiag = self.kernel.diag(Y, True, **options)

        K, lr, rr = _cosine(R, ldiag, rdiag)
        # d(K) = d(R)/sqrt(ll rr) - K/2 * (dl/l + dr/r)
        dK = (
            dR * lr[:, None, None] * rr[None, :, None]
            - 0.5 * K[:, :, None] * (
                (ldDiag / ldiag[:, None])[:, None, :]
                + (rdDiag / rdiag[:, None])[None, :, :]
            )
        )
        return K, np.asfortranarray(dK)

    def diag(self, X, eval_gradient=False, **options):
        """Identically one (with zero gradient)."""
        ones = np.ones(len(X))
        if eval_gradient:
            return ones, np.zeros((len(X), len(self.kernel.theta)))
        return ones


class Exponentiation(_Wrapper):
    r"""Raises a kernel to a trainable power:
    :math:`k_e(x, y) = k(x, y)^\xi`.

    Parameters
    ----------
    kernel: object
    xi: float
        The exponent (prepended to theta).
    xi_bounds: (float, float)
        Optimization range of the exponent.
    """

    def __init__(self, kernel, xi=1.0, xi_bounds=(0.1, 20.0)):
        super().__init__(kernel)
        self.xi = xi
        self.xi_bounds = xi_bounds

    def __call__(self, X, Y=None, eval_gradient=False, **options):
        if not eval_gradient:
            return self.kernel(X, Y, **options) ** self.xi
        R, dR = self.kernel(X, Y, eval_gradient=True, **options)
        K = R ** self.xi
        # columns: [d/dxi, then base-kernel derivatives via power rule]
        dK = np.concatenate([
            (K * np.log(R))[:, :, None],
            (self.xi * R ** (self.xi - 1))[:, :, None] * dR,
        ], axis=2)
        return K, dK

    def diag(self, X, **options):
        return self.kernel.diag(X, **options) ** self.xi

    @property
    def hyperparameters(self):
        return pretty_tuple('Exponentiation', ['xi', 'kernel'])(
            self.xi, self.kernel.hyperparameters
        )

    @property
    def hyperparameter_bounds(self):
        return pretty_tuple('Exponentiation', ['xi', 'kernel'])(
            self.xi_bounds, self.kernel.hyperparameter_bounds
        )

    @property
    def theta(self):
        return np.concatenate((np.log([self.xi]), self.kernel.theta))

    @theta.setter
    def theta(self, value):
        self.xi = np.exp(value[0])
        self.kernel.theta = value[1:]

    @property
    def bounds(self):
        return np.vstack((np.log([self.xi_bounds]), self.kernel.bounds))
