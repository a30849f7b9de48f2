"""Gaussian process regression; counterpart of
``graphdot_tpu/model/gaussian_process/gpr.py``.

The LML and LOOCV objectives are scalar torch functions of the Gram
matrix, run in float64 on the model's ``device`` (:mod:`._objectives`);
their hyperparameter gradients come from ``torch.autograd`` contracted
against the kernel jacobian. The public sklearn-style surface (fit /
predict / predict_loocv / log_marginal_likelihood / squared_loocv_error)
is the JAX class's, with one more argument, ``device``.
"""
import time

import numpy as np

from ...util.printer import markdown as mprint
from ...util.trace import spanned
from . import _objectives as obj
from .base import GaussianProcessRegressorBase


class GaussianProcessRegressor(GaussianProcessRegressorBase):
    """GPR over arbitrary objects through a kernel.

    Parameters
    ----------
    kernel: kernel instance
        The covariance function of the GP.
    alpha: float > 0
        Diagonal regularization (observation noise / jitter).
    beta: float > 0
        Eigenvalue cutoff of the clamped-pseudoinverse fallback.
    optimizer: str, True, None, or callable
        A scipy.optimize.minimize method name; True selects L-BFGS-B;
        None disables hyperparameter optimization.
    normalize_y: bool
        Standardize targets during fitting (undone at prediction).
    regularization: '+'/'additive' or '*'/'multiplicative'
    kernel_options: dict
        Extra keyword arguments for every kernel invocation.
    device: torch device (or its name) of the objectives' linear algebra:
        the card (``'cuda'``) unless the caller asks for ``'cpu'``.
    """

    def __init__(self, kernel, alpha=1e-8, beta=1e-8, optimizer=None,
                 normalize_y=False, regularization='+', kernel_options={},
                 device='cuda'):
        super().__init__(
            kernel, normalize_y=normalize_y, regularization=regularization,
            kernel_options=kernel_options, device=device)
        self.alpha = alpha
        self.beta = beta
        self.optimizer = 'L-BFGS-B' if optimizer is True else optimizer

    # -- training ---------------------------------------------------------

    def fit(self, X, y, loss='likelihood', tol=1e-5, repeat=1,
            theta_jitter=1.0, verbose=False):
        """Fit the model, optionally optimizing theta under the chosen
        loss ('likelihood' or 'loocv') first. Returns self."""
        self.X = X
        self.y = y
        # a factory packs the graphs once for every objective evaluation;
        # a fit without an optimizer evaluates the Gram once
        self._engine = (
            self._make_factory_engine(self.kernel, self._X)
            if self.optimizer and len(self._X) >= 16 else None
        )

        if self.optimizer:
            try:
                objective = {
                    'likelihood': self.log_marginal_likelihood,
                    'loocv': self.squared_loocv_error,
                }[loss]
            except KeyError:
                raise RuntimeError(f'Unknown loss function: {loss}.')
            best = self._hyper_opt(
                method=self.optimizer,
                fun=lambda t: objective(
                    t, eval_gradient=True, clone_kernel=False,
                    verbose=verbose),
                xgen=self._theta_restarts(repeat, theta_jitter),
                tol=tol, verbose=verbose)
            if verbose:
                print(f'Optimization result:\n{best}')
            if not best.success:
                raise RuntimeError(
                    f'Training using the {loss} loss did not converge, '
                    f'got:\n{best}')
            self.kernel.theta = best.x

        if self._engine is not None:
            K = self._engine_gramian(self.alpha, self.kernel.theta, False)
        else:
            K = self._gramian(self.alpha, self._X)
        self._K_train = K = K[np.ix_(self._y_mask, self._y_mask)]
        self._K_inv, _, _ = obj.inverse(K, self.beta, self.device)
        self._weights = self._K_inv @ self._y
        return self

    def fit_loocv(self, X, y, **options):
        """Fit under the LOOCV loss."""
        return self.fit(X, y, loss='loocv', **options)

    # -- prediction -------------------------------------------------------

    def predict(self, Z, return_std=False, return_cov=False):
        """Posterior mean at Z, optionally with std or covariance."""
        if not hasattr(self, '_K_inv'):
            raise RuntimeError('Model not trained.')
        Ks = self._gramian(None, Z, self._X)[:, self._y_mask]
        mean = Ks @ self._weights * self._ystd + self._ymean
        if return_std:
            prior = self._gramian(self.alpha, Z, diag=True)
            explained = np.einsum('ij,jk,ik->i', Ks, self._K_inv, Ks)
            std = np.sqrt(np.maximum(prior - explained, 0.0))
            return mean, std * self._ystd
        if return_cov:
            prior = self._gramian(self.alpha, Z)
            cov = np.maximum(prior - Ks @ self._K_inv @ Ks.T, 0.0)
            return mean, cov * self._ystd ** 2
        return mean

    def predict_loocv(self, Z, z, return_std=False):
        """Leave-one-out predictions via the closed form
        z* = z - (K^-1 z) / diag(K^-1), without refitting."""
        z_mask, z = self.mask(z)
        if self.normalize_y:
            z_mean, z_std = z.mean(), z.std()
            z = (z - z_mean) / z_std
        else:
            z_mean, z_std = 0.0, 1.0

        K = self._gramian(self.alpha, Z)[np.ix_(z_mask, z_mask)]
        K_inv, _, _ = obj.inverse(K, self.beta, self.device)
        precision = K_inv.diagonal()
        loo = z - (K_inv @ z) / precision
        if return_std:
            std = np.sqrt(1.0 / np.maximum(precision, 1e-14))
            return loo * z_std + z_mean, std * z_std
        return loo * z_std + z_mean

    # -- objectives ---------------------------------------------------------

    def _theta_context(self, theta, X, y, eval_gradient, clone_kernel):
        """Resolve (theta, masked y, Gram pieces) for an objective call."""
        theta = self.kernel.theta if theta is None else theta
        X = self._X if X is None else X
        if y is None:
            y, y_mask = self._y, self._y_mask
        else:
            y_mask, y = self.mask(y)

        if clone_kernel:
            kernel = self.kernel.clone_with_theta(theta)
        else:
            kernel = self.kernel
            kernel.theta = theta

        started = time.perf_counter()
        engine = getattr(self, '_engine', None)
        use_engine = engine is not None and X is self._X
        if eval_gradient:
            if use_engine:
                K, dK = self._engine_gramian(self.alpha, theta, True)
            else:
                K, dK = self._gramian(
                    self.alpha, X, kernel=kernel, jac=True)
            K = K[np.ix_(y_mask, y_mask)]
            dK = dK[np.ix_(y_mask, y_mask)]
        else:
            if use_engine:
                K = self._engine_gramian(self.alpha, theta, False)
            else:
                K = self._gramian(self.alpha, X, kernel=kernel)
            K = K[np.ix_(y_mask, y_mask)]
            dK = None
        return theta, y, K, dK, time.perf_counter() - started

    @spanned('gp_objective')
    def log_marginal_likelihood(self, theta=None, X=None, y=None,
                                eval_gradient=False, clone_kernel=True,
                                verbose=False):
        """Negative log marginal likelihood y^T K^-1 y + log|K| at
        log-scale theta, with its autograd gradient when requested."""
        theta, y, K, dK, t_kernel = self._theta_context(
            theta, X, y, eval_gradient, clone_kernel)

        started = time.perf_counter()
        if eval_gradient:
            value, (gK,) = obj.negative_log_marginal(
                K, y, self.beta, with_grad=True, device=self.device)
            grad = obj.chain_to_theta(gK, dK, theta, self.device)
        else:
            value = obj.negative_log_marginal(K, y, self.beta,
                                              device=self.device)
        t_linalg = time.perf_counter() - started

        if verbose and eval_gradient:
            mprint.table(
                ('logP', '%12.5g', value),
                ('dlogP', '%12.5g', np.linalg.norm(grad)),
                ('Cond(K)', '%12.5g', np.linalg.cond(K)),
                ('t_kernel', '%10.2g', t_kernel),
                ('t_linalg', '%10.2g', t_linalg),
            )
        return (float(value), grad) if eval_gradient else float(value)

    @spanned('gp_objective')
    def squared_loocv_error(self, theta=None, X=None, y=None,
                            eval_gradient=False, clone_kernel=True,
                            verbose=False):
        """Half the squared LOOCV residual norm at log-scale theta, with
        its autograd gradient when requested."""
        theta, y, K, dK, t_kernel = self._theta_context(
            theta, X, y, eval_gradient, clone_kernel)

        started = time.perf_counter()
        if eval_gradient:
            value, (gK,) = obj.loocv_error(
                K, y, self.beta, with_grad=True, device=self.device)
            grad = obj.chain_to_theta(gK, dK, theta, self.device)
        else:
            value = obj.loocv_error(K, y, self.beta, device=self.device)
        t_linalg = time.perf_counter() - started

        if verbose and eval_gradient:
            mprint.table(
                ('Sq.Err.', '%12.5g', value),
                ('Cond(K)', '%12.5g', np.linalg.cond(K)),
                ('t_kernel', '%10.2g', t_kernel),
                ('t_linalg', '%10.2g', t_linalg),
            )
        return (float(value), grad) if eval_gradient else float(value)
