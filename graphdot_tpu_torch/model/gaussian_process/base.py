"""Shared foundation of the Gaussian-process models; counterpart of
``graphdot_tpu/model/gaussian_process/base.py``.

Targets are masked and standardized on the host, Gram matrices come from
the kernel layer, and the likelihood's linear algebra runs in float64 on
the model's ``device`` (:mod:`._objectives`). For a
``MarginalizedGraphKernel`` (or a ``Normalization`` of one) over graphs,
the training Gram and its jacobian come from one
:class:`~graphdot_tpu_torch.inference.GramFactory`, which packs the graphs
once for every objective evaluation of the fit.

Where the port differs: the factory engine declines only on the shape
conditions of the JAX module, never by catching an exception, and
:meth:`GaussianProcessRegressorBase.save` leaves the engine out (the JAX
module pickles it, a local closure, and so cannot save a model fitted
through it).
"""
import os
import pickle

import numpy as np
from scipy.optimize import minimize

from ...util.printer import markdown as mprint
from ...util.trace import span


def valid_targets(values):
    """(mask, finite values) for a target sequence that may contain
    None / NaN placeholders for unlabeled samples."""
    flags = np.array(
        [v is not None and np.isfinite(v) for v in values], dtype=bool)
    kept = np.array(
        [v for v, ok in zip(values, flags) if ok], dtype=float)
    return flags, kept


class GaussianProcessRegressorBase:
    """Target bookkeeping, Gram assembly, and hyperparameter optimization
    shared by the GP models. ``device``: where the objectives' linear
    algebra runs, the card (``'cuda'``) unless the caller asks for
    ``'cpu'``."""

    def __init__(self, kernel, normalize_y, regularization, kernel_options,
                 device='cuda'):
        self.kernel = kernel
        self.normalize_y = normalize_y
        self.regularization = regularization
        self.kernel_options = kernel_options
        self.device = device

    # -- training data ----------------------------------------------------

    mask = staticmethod(valid_targets)

    @property
    def X(self):
        """Training inputs."""
        if not hasattr(self, '_X'):
            raise AttributeError(
                'Training data does not exist. Please provide using fit().')
        return self._X

    @X.setter
    def X(self, inputs):
        self._X = np.asarray(inputs)

    @property
    def y(self):
        """Training targets (in their original units)."""
        if not hasattr(self, '_y'):
            raise AttributeError(
                'Training data does not exist. Please provide using fit().')
        return self._y * self._ystd + self._ymean

    @y.setter
    def y(self, targets):
        self._y_mask, kept = valid_targets(targets)
        if self.normalize_y:
            self._ymean = kept.mean()
            self._ystd = kept.std()
        else:
            self._ymean, self._ystd = 0.0, 1.0
        self._y = (kept - self._ymean) / self._ystd

    # -- Gram assembly ------------------------------------------------------

    def _regularize(self, diagonal, alpha):
        """Apply the configured diagonal regularization rule."""
        if self.regularization in ('+', 'additive'):
            return diagonal + alpha
        if self.regularization in ('*', 'multiplicative'):
            return diagonal * (1.0 + alpha)
        raise RuntimeError(
            f'Unknown regularization method {self.regularization}.')

    def _make_factory_engine(self, kernel, X):
        """A GramFactory-backed ``engine(theta_log, jac)`` giving the
        (normalized, for a ``Normalization``) training Gram and, with
        ``jac``, its jacobian in the linear-scale hyperparameters, as numpy
        float64. Returns None when the inputs do not qualify:
        ``GRAPHDOT_GPR_ENGINE=0``, kernel options, a kernel other than a
        ``MarginalizedGraphKernel`` or a ``Normalization`` of one, or inputs
        that are not graphs."""
        if os.environ.get('GRAPHDOT_GPR_ENGINE', '1') == '0':
            return None
        if self.kernel_options:
            return None
        from ...inference import GramFactory
        from ...kernel.fix import Normalization
        from ...kernel.marginalized import MarginalizedGraphKernel
        if (type(kernel) is Normalization
                and type(kernel.kernel) is MarginalizedGraphKernel):
            inner, normalize = kernel.kernel, True
        elif type(kernel) is MarginalizedGraphKernel:
            inner, normalize = kernel, False
        else:
            return None
        if len(X) == 0 or not all(hasattr(g, 'nodes') for g in X):
            return None
        factory = GramFactory(inner, list(X), normalize=normalize)

        def engine(theta_log, jac):
            out = factory.gram(theta_log, eval_gradient=jac)
            out = [t.double() for t in out] if jac else out.double()
            with span('host_sync'):
                if not jac:
                    return out.cpu().numpy()
                K, dK = (t.cpu().numpy() for t in out)
            # the factory's jacobian is in log theta; chain_to_theta
            # expects the linear-scale one
            return K, dK / np.exp(theta_log)[None, None, :]

        return engine

    def _engine_gramian(self, alpha, theta_log, jac):
        """Training Gram (and jacobian) through the factory engine, with
        the same diagonal regularization as :meth:`_gramian`."""
        out = self._engine(theta_log, jac)
        K = out[0] if jac else out
        idx = np.diag_indices_from(K)
        K[idx] = self._regularize(K[idx], alpha)
        return out

    def _gramian(self, alpha, X, Y=None, kernel=None, jac=False,
                 diag=False):
        """Kernel matrix (or diagonal) between X and Y; the training
        (Y=None) diagonal is regularized by ``alpha``."""
        kernel = kernel if kernel is not None else self.kernel
        opts = self.kernel_options
        grad_opt = {'eval_gradient': True} if jac else {}
        if Y is not None:
            if diag:
                raise ValueError(
                    'Diagonal Gramian does not exist between two sets.')
            return kernel(X, Y, **grad_opt, **opts)
        if diag:
            return self._regularize(kernel.diag(X, **opts), alpha)
        out = kernel(X, **grad_opt, **opts)
        K = out[0] if jac else out
        idx = np.diag_indices_from(K)
        K[idx] = self._regularize(K[idx], alpha)
        return out

    # -- hyperparameter optimization ----------------------------------------

    def _hyper_opt(self, method, fun, xgen, tol, verbose):
        """Multi-restart local minimization over log-scale theta; returns
        the best successful result (or the best attempt if none
        converged)."""
        attempts = []
        for x0 in xgen:
            if verbose:
                mprint.table_start()
            attempts.append(minimize(
                fun=fun, x0=x0, method=method, jac=True,
                bounds=self.kernel.bounds, tol=tol,
            ))
        converged = [a for a in attempts if a.success]
        return min(converged or attempts, key=lambda a: a.fun)

    def _theta_restarts(self, repeat, jitter):
        start = self.kernel.theta.copy()
        yield start
        for _ in range(int(repeat) - 1):
            yield start + jitter * np.random.randn(len(start))

    # -- persistence ----------------------------------------------------------

    def save(self, path, filename='model.pkl', overwrite=False):
        """Pickle the model state; the kernel object itself is replaced by
        its hyperparameter vector (reference ``base.py:150-189``), and the
        factory engine, which holds device tensors, is left out."""
        target = os.path.join(path, filename)
        if os.path.isfile(target) and not overwrite:
            raise RuntimeError(
                f'Path {target} already exists. To overwrite, set '
                '`overwrite=True`.')
        state = {k: v for k, v in self.__dict__.items()
                 if k not in ('kernel', '_engine')}
        state['theta'] = self.kernel.theta
        with open(target, 'wb') as f:
            pickle.dump(state, f, protocol=4)

    def load(self, path, filename='model.pkl'):
        """Restore state written by :meth:`save` onto this instance."""
        with open(os.path.join(path, filename), 'rb') as f:
            state = pickle.load(f)
        self.kernel.theta = state.pop('theta')
        self.__dict__.update(state)
