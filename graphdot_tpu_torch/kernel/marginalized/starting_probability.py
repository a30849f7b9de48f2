"""Starting probability of the random walk; counterpart of
``graphdot_tpu/kernel/marginalized/starting_probability.py``.

Each starting probability implements ``apply(theta, node_mask)`` on tensors
and a host-side ``__call__``. Ad-hoc probabilities are evaluated host-side
per batch (they carry no trainable hyperparameters).
"""
from abc import ABC, abstractmethod

import numpy as np

from ...util.pretty_tuple import pretty_tuple


class StartingProbability(ABC):
    """Assigns non-negative starting probabilities to each node of a
    graph; the probabilities do not have to sum to 1."""

    @abstractmethod
    def __call__(self, nodes):
        """Takes a dataframe of nodes; returns (p, dp) where dp rows are
        gradients w.r.t. each hyperparameter."""

    @property
    @abstractmethod
    def theta(self):
        pass

    @theta.setter
    @abstractmethod
    def theta(self, t):
        pass

    @property
    @abstractmethod
    def bounds(self):
        pass

    @property
    def n_theta(self):
        return len(tuple(self.theta))

    def apply(self, theta, node_mask, p_fixed=None):
        """Per-node starting probabilities as a tensor.

        Parameters
        ----------
        theta: [n_theta] linear-scale hyperparameters.
        node_mask: [..., n] validity mask.
        p_fixed: optional [..., n] host-precomputed values (Adhoc path).
        """
        raise NotImplementedError


class Uniform(StartingProbability):
    """The same trainable starting probability on every node.

    Parameters
    ----------
    p: float
        The starting probability value.
    p_bounds: (float, float) or "fixed"
        The training range of p.
    """

    def __init__(self, p, p_bounds=(1e-3, 1e3)):
        if p_bounds != 'fixed':
            lo, hi = p_bounds  # must be a 2-tuple
        self.p = p
        self.p_bounds = p_bounds

    def __call__(self, nodes):
        count = len(nodes)
        return np.full(count, self.p), np.ones((1, count))

    def apply(self, theta, node_mask, p_fixed=None):
        return theta[0] * node_mask

    @property
    def theta(self):
        return pretty_tuple('Uniform', ['p'])(self.p)

    @theta.setter
    def theta(self, t):
        (self.p,) = t

    @property
    def bounds(self):
        return (self.p_bounds,)


class Adhoc(StartingProbability):
    """Fixed (untrainable) per-node starting probabilities from a
    user-supplied callable over the node dataframe.

    Parameters
    ----------
    f: callable
        Takes a node dataframe, returns a same-length ndarray.
    expr: str
        Kept for signature parity with the JAX package; unused.
    """

    def __init__(self, f, expr=''):
        self.f = f
        self.expr = expr

    def __call__(self, nodes):
        return self.f(nodes), np.empty((0, 0))

    def apply(self, theta, node_mask, p_fixed=None):
        if p_fixed is None:
            raise ValueError(
                'Adhoc starting probabilities must be precomputed '
                'host-side')
        return p_fixed * node_mask

    theta = property(lambda self: tuple())

    @theta.setter
    def theta(self, t):
        pass

    bounds = property(lambda self: tuple())
