"""Preset molecular kernel; counterpart of
``graphdot_tpu/kernel/molecular.py``."""
import copy

from .marginalized import MarginalizedGraphKernel
from ..microkernel import KroneckerDelta, SquareExponential, TensorProduct


class Tang2019MolecularKernel:
    """Marginalized graph kernel preset for 3D molecular structures
    (Tang & de Jong, J. Chem. Phys. 150:044107, 2019): Kronecker-delta
    node kernel on elements, square-exponential edge kernel on bond
    lengths. Compose with ``Graph.from_ase``.

    Parameters
    ----------
    stopping_probability: float in (0, 1)
        Per-step stopping probability q of the random walk.
    starting_probability: float
        Starting probability p on every node.
    element_prior: float in (0, 1)
        Similarity floor between distinct chemical elements.
    edge_length_scale: float > 0
        Gaussian length scale on interatomic distances.
    kwargs: forwarded to MarginalizedGraphKernel; ``device`` is the card
        (``'cuda'``) unless given.
    """

    def __init__(self, stopping_probability=0.01, starting_probability=1.0,
                 element_prior=0.2, edge_length_scale=0.05, **kwargs):
        self.stopping_probability = stopping_probability
        self.starting_probability = starting_probability
        self.element_prior = element_prior
        self.edge_length_scale = edge_length_scale
        self._makekernel(**kwargs)

    def _makekernel(self, **kwargs):
        self.kernel = MarginalizedGraphKernel(
            node_kernel=TensorProduct(
                element=KroneckerDelta(self.element_prior)
            ),
            edge_kernel=TensorProduct(
                length=SquareExponential(self.edge_length_scale)
            ),
            p=self.starting_probability,
            q=self.stopping_probability,
            **kwargs
        )

    def __call__(self, X, Y=None, **kwargs):
        return self.kernel(X, Y, **kwargs)

    def diag(self, X, **kwargs):
        return self.kernel.diag(X, **kwargs)

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
        """A copy at ``theta``; the graph kernel's clone shares its factory
        cache."""
        twin = copy.copy(self)
        twin.kernel = self.kernel.clone_with_theta(theta)
        return twin
