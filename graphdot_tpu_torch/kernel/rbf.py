"""Standalone RBF kernel over vector data; counterpart of
``graphdot_tpu/kernel/rbf.py``.

The pairwise distance matrix and the kernel map run in float64 on the
kernel's device (the expression lambdified to torch through the port's
``_TORCH_MODULE``), and the hyperparameter gradient comes from
``torch.func.jacfwd`` where the JAX module takes ``jax.jacfwd``. What
differs from the JAX module: ``device`` (default: the card).
"""
from collections import OrderedDict

import numpy as np
import sympy
import torch
from sympy.utilities.lambdify import lambdify

from ..microkernel._sympy import _TORCH_MODULE
from .marginalized._backend import resolve_device


def _pairwise_dist(X, Y):
    """Euclidean cdist with a branch-free clamped sqrt."""
    sq = (
        torch.sum(X * X, dim=1)[:, None]
        - 2.0 * (X @ Y.T)
        + torch.sum(Y * Y, dim=1)[None, :]
    )
    return torch.sqrt(torch.clamp(sq, min=0.0))


class RBFKernel:
    """k(x, y) = f(||x - y||) for a SymPy expression f of a distance
    variable and named hyperparameters.

    Parameters
    ----------
    expr: str
        SymPy expression, e.g. ``'exp(-0.5 * d**2 / s**2)'``.
    x: str
        The distance variable's name in ``expr``.
    device: torch device (or its name); the card (``'cuda'``) unless the
        caller asks for the CPU. A CUDA device without a card raises.
    hyperparameters: name=value pairs for the remaining symbols.
    """

    def __init__(self, expr, x, device='cuda', **hyperparameters):
        self.device = resolve_device(device)
        self.expr = sympy.sympify(expr)
        self._params = OrderedDict(hyperparameters)
        symbols = [sympy.Symbol(x)] + [
            sympy.Symbol(name) for name in self._params
        ]
        f = lambdify(symbols, self.expr, modules=_TORCH_MODULE)

        def kmat(X, Y, p):
            return f(_pairwise_dist(X, Y), *p)

        def kgrad(X, p):
            d = _pairwise_dist(X, X)
            return torch.func.jacfwd(lambda q: f(d, *q))(p)

        def kdiag(n_as_zeros, p):
            return f(n_as_zeros, *p)

        self._kmat, self._kgrad, self._kdiag = kmat, kgrad, kdiag

    def _run(self, fn, *arrays):
        """``fn`` on float64 tensors on the device; numpy out."""
        return fn(*(torch.as_tensor(np.asarray(a, dtype=np.float64),
                                    device=self.device)
                    for a in arrays)).cpu().numpy()

    @property
    def _p(self):
        return np.asarray(list(self._params.values()), dtype=float)

    def get_params(self):
        return self._params

    @property
    def theta(self):
        return np.log(list(self._params.values()))

    @theta.setter
    def theta(self, args):
        for name, value in zip(self._params, np.exp(args)):
            self._params[name] = value

    def __call__(self, X, Y=None):
        X = np.asarray(X, dtype=float)
        Y = X if Y is None else np.asarray(Y, dtype=float)
        return self._run(self._kmat, X, Y, self._p)

    def gradient(self, X):
        J = self._run(self._kgrad, np.asarray(X, dtype=float), self._p)
        return [J[..., i] for i in range(len(self._params))]

    def diag(self, X):
        return self._run(self._kdiag, np.zeros(len(X)), self._p)
