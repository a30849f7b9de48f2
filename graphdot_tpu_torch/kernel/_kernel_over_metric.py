"""Kernel defined as a function of a distance metric; counterpart of
``graphdot_tpu/kernel/_kernel_over_metric.py``.

k(x, y) = f(d(x, y)) for a SymPy expression f of the distance and named
hyperparameters. The scalar map runs in float64 on the distance's device:
the expression is lambdified to torch (the port's ``_TORCH_MODULE``), and
its derivatives, in its own hyperparameters and in the distance (to chain
through the metric's gradient), come from ``torch.func.jacfwd`` and
``torch.func.jvp`` where the JAX module takes ``jax.jacfwd`` and
``jax.jvp``. What differs from the JAX module: ``device`` (default: the
distance's ``device``, else the card).
"""
from collections import OrderedDict

import numpy as np
import sympy
import torch
from sympy.utilities.lambdify import lambdify

from ..microkernel._sympy import _TORCH_MODULE
from ..util.pretty_tuple import pretty_tuple
from .marginalized._backend import resolve_device


def _parse_hyper_spec(val):
    """value | (value,) | (value, bounds) | (value, lb, ub)."""
    if not hasattr(val, '__iter__'):
        return val, (0, np.inf)
    val = tuple(val)
    if len(val) == 1:
        return val[0], (0, np.inf)
    if len(val) == 2:
        return val[0], val[1]
    if len(val) == 3:
        return val[0], (val[1], val[2])
    raise ValueError(f'Bad hyperparameter spec {val!r}')


class KernelOverMetric:
    """k(x, y) = f(d(x, y)) with gradients chained through both f's
    hyperparameters and the distance metric's.

    Parameters
    ----------
    distance: metric object with theta / bounds / clone_with_theta.
    expr: str
        SymPy expression in the distance variable plus hyperparameters.
    x: str
        Distance variable name.
    device: torch device (or its name) of the scalar map; None takes the
        distance's ``device``, or the card (``'cuda'``) where it has none.
        A CUDA device without a card raises.
    hyperparameters: name=value or name=(value, bounds...) pairs.
    """

    def __init__(self, distance, expr, x, device=None, **hyperparameters):
        self._init_args = (expr, x)
        self._init_kwargs = hyperparameters
        self.distance = distance
        if device is None:
            device = getattr(distance, 'device', None) or 'cuda'
        self.device = resolve_device(device)
        self.expr = sympy.sympify(expr)
        self.x = x
        self._hyperparams = OrderedDict()
        self._hyperbounds = OrderedDict()
        for name, spec in hyperparameters.items():
            value, bounds = _parse_hyper_spec(spec)
            self._hyperparams[name] = value
            self._hyperbounds[name] = bounds

        symbols = [sympy.Symbol(x)] + [
            sympy.Symbol(name) for name in self._hyperparams
        ]
        f = lambdify(symbols, self.expr, modules=_TORCH_MODULE)

        def kfun(D, p):
            return f(D, *p)

        def kjac(D, p):
            # forward mode over the (few) hyperparameters; one JVP for
            # the elementwise distance derivative
            dp = torch.func.jacfwd(lambda q: f(D, *q))(p)
            _, dd = torch.func.jvp(lambda d: f(d, *p), (D,),
                                   (torch.ones_like(D),))
            return dp, dd

        self._kfun, self._kjac = kfun, kjac

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)

    def _values(self):
        return self._tensor(list(self._hyperparams.values()))

    def _run(self, fn, D):
        """``fn(D, p)`` on the device; numpy out."""
        out = fn(self._tensor(D), self._values())
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def __call__(self, X, Y=None, eval_gradient=False):
        if not eval_gradient:
            return self._run(self._kfun, self.distance(X, Y))
        D, dD = self.distance(X, Y, eval_gradient=True)
        K = self._run(self._kfun, D)
        dp, dd = self._run(self._kjac, D)
        n_own = len(self._hyperparams)
        n_dist = len(self.distance.theta)
        grad = np.empty((*D.shape, n_own + n_dist), order='F')
        grad[:, :, :n_own] = dp
        if n_dist:
            grad[:, :, n_own:] = dd[:, :, None] * dD
        return K, grad

    def diag(self, X):
        return self._run(self._kfun, np.zeros(len(X)))

    def get_params(self):
        return self._hyperparams

    @property
    def theta(self):
        return np.concatenate((
            np.log(list(self._hyperparams.values())),
            self.distance.theta,
        ))

    @theta.setter
    def theta(self, args):
        own = len(self._hyperparams)
        for name, value in zip(self._hyperparams, np.exp(args[:own])):
            self._hyperparams[name] = value
        self.distance.theta = args[own:]

    @property
    def bounds(self):
        return np.vstack((
            np.log(np.vstack(list(self._hyperbounds.values()))),
            self.distance.bounds,
        ))

    @property
    def hyperparameters(self):
        return pretty_tuple(
            'RBFKernel',
            list(self._hyperparams) + ['distance']
        )(*self._hyperparams.values(), self.distance.hyperparameters)

    def clone_with_theta(self, theta=None):
        if theta is None:
            theta = self.theta
        twin = type(self)(
            self.distance.clone_with_theta(self.distance.theta),
            *self._init_args, device=self.device, **self._init_kwargs
        )
        twin.theta = theta
        return twin
