"""Weight functions for Gaussian field models; a copy of
``graphdot_tpu/model/gaussian_field/weight.py`` (numpy only).

Gradients are w.r.t. the **log-scale** hyperparameters throughout.
:class:`RBFOverDistance` takes a metric of the port, such as
:class:`graphdot_tpu_torch.metric.MaxiMin`, which computes its distances
and their linear-scale gradient on its own device; the chain onto the
metric's log theta happens here, on the host.
"""
from abc import ABC, abstractmethod
import copy

import numpy as np


def _gaussian(d, sigma):
    """exp(-d^2 / 2 sigma^2) and its log-sigma derivative."""
    w = np.exp(-0.5 * (d / sigma) ** 2)
    return w, w * (d / sigma) ** 2


class Weight(ABC):
    """A trainable edge-weight function.

    Subclasses expose log-scale hyperparameters by listing the trainable
    pieces in :meth:`_hyper_parts` as ``(log values, log bounds)`` pairs;
    ``theta``/``bounds`` concatenate them in order.
    """

    @abstractmethod
    def __call__(self, X, Y=None, eval_gradient=False):
        """Weight matrix between X and Y (or X with itself when Y is
        None); with ``eval_gradient``, also the jacobian w.r.t. the
        log-scale hyperparameters stacked along the last axis."""

    @abstractmethod
    def _hyper_parts(self):
        """Ordered [(log values, log bounds)] of trainable pieces."""

    @abstractmethod
    def _set_theta(self, values):
        pass

    @property
    def theta(self):
        return np.concatenate(
            [np.atleast_1d(v) for v, _ in self._hyper_parts()])

    @theta.setter
    def theta(self, values):
        self._set_theta(np.asarray(values))

    @property
    def bounds(self):
        return np.vstack([
            np.atleast_2d(b) for _, b in self._hyper_parts()])

    def clone_with_theta(self, theta):
        twin = copy.deepcopy(self)
        twin.theta = theta
        return twin


class RBFOverDistance(Weight):
    """Gaussian weights over a (trainable) distance metric.

    Parameters
    ----------
    metric: callable
        Distance metric object (e.g. MaxiMin).
    sigma: float
        RBF length scale.
    sigma_bounds: tuple
        Optimization bounds of sigma.
    mopts: dict
        Extra options for metric invocations.
    """

    def __init__(self, metric, sigma, sigma_bounds=(1e-3, 1e3), mopts={}):
        self.sigma = sigma
        self.sigma_bounds = sigma_bounds
        self.metric = metric
        self.mopts = mopts

    def _hyper_parts(self):
        return [
            (np.log(self.sigma), np.log(self.sigma_bounds)),
            (self.metric.theta, self.metric.bounds),
        ]

    def _set_theta(self, values):
        self.sigma = np.exp(values[0])
        self.metric.theta = values[1:]

    def __call__(self, X, Y=None, eval_gradient=False):
        sets = (X,) if Y is None else (X, Y)
        if not eval_gradient:
            W, _ = _gaussian(self.metric(*sets, **self.mopts), self.sigma)
            if Y is None:
                np.fill_diagonal(W, 0.0)
            return W

        D, dD = self.metric(*sets, eval_gradient=True, **self.mopts)
        W, d_log_sigma = _gaussian(D, self.sigma)
        if Y is None:
            np.fill_diagonal(W, 0.0)
        # metric jacobians are linear-scale; chain onto log(metric.theta)
        d_metric = (
            (-D * W / self.sigma ** 2)[..., None]
            * dD * np.exp(self.metric.theta)
        )
        return W, np.concatenate(
            [d_log_sigma[..., None], d_metric], axis=-1)


class RBFOverFixedDistance(Weight):
    """Gaussian weights over a fixed, precomputed distance matrix,
    indexed by integer sample ids; only sigma is trainable."""

    def __init__(self, D, sigma, sigma_bounds=(1e-3, 1e3),
                 sticky_cache=False):
        self.sigma = sigma
        self.sigma_bounds = sigma_bounds
        self.D = np.asarray(D)

    def _hyper_parts(self):
        return [(np.log(self.sigma), np.log(self.sigma_bounds))]

    def _set_theta(self, values):
        self.sigma = float(np.exp(values[0]))

    def __call__(self, X, Y=None, eval_gradient=False):
        d = self.D[np.ix_(X, X if Y is None else Y)]
        W, d_log_sigma = _gaussian(d, self.sigma)
        if Y is None:
            np.fill_diagonal(W, 0.0)
        if eval_gradient:
            return W, d_log_sigma[..., None]
        return W
