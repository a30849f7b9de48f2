"""GPR with learned per-sample noise for outlier detection; counterpart of
``graphdot_tpu/model/gaussian_process/outlier_detector.py``.

The hyperparameter vector is the kernel's theta followed by one log-noise
entry per training sample, and an L1 penalty drives most noises to the
floor, so samples inconsistent with the rest stand out with a large
learned sigma_i. With K_total = K + diag(sigma^2), the gradient in the
noises is d nll / d log sigma_i = 2 sigma_i^2 (d nll / d K)_ii, from the
same autograd matrix gradient (on the model's ``device``) as the kernel's
part. What differs from the JAX class: ``device``.
"""
import numpy as np
from scipy.optimize import minimize

from ...util.printer import markdown as mprint
from . import _objectives as obj
from .base import GaussianProcessRegressorBase


class GPROutlierDetector(GaussianProcessRegressorBase):
    """Maximum-likelihood GPR with per-sample noise (outlier scores).

    Parameters
    ----------
    kernel: kernel instance
    sigma_bounds: (float, float)
        Allowed range of each per-sample noise magnitude.
    beta: float > 0
        Eigenvalue cutoff of the pseudoinverse fallback.
    optimizer: str, True, None, or callable
    normalize_y: bool
    kernel_options: dict
    device: torch device (or its name) of the objective's linear algebra:
        the card (``'cuda'``) unless the caller asks for ``'cpu'``.
    """

    def __init__(self, kernel, sigma_bounds=(1e-4, np.inf), beta=1e-8,
                 optimizer=True, normalize_y=False, kernel_options={},
                 device='cuda'):
        super().__init__(
            kernel, normalize_y=normalize_y, regularization='+',
            kernel_options=kernel_options, device=device)
        self.sigma_bounds = sigma_bounds
        self.beta = beta
        self.optimizer = 'L-BFGS-B' if optimizer is True else optimizer

    @property
    def y_uncertainty(self):
        """Learned per-sample noise magnitudes (original y units)."""
        if not hasattr(self, '_sigma'):
            raise AttributeError('Uncertainty must be learned via fit().')
        return self._sigma * self._ystd

    def _split(self, theta_ext):
        """(kernel theta, log sigma) halves of the extended vector."""
        pivot = len(self.kernel.theta)
        return theta_ext[:pivot], theta_ext[pivot:]

    # -- training ---------------------------------------------------------

    def fit(self, X, y, w, udist=None, tol=1e-4, repeat=1,
            theta_jitter=1.0, verbose=False):
        """Fit with L1-penalized per-sample noise.

        Parameters
        ----------
        w: float
            L1 penalty strength on the noise magnitudes.
        udist: callable(n) -> ndarray, optional
            Sampler of initial noise guesses (lognormal from the global
            ``np.random`` by default).

        Returns self.
        """
        self.X = X
        self.y = y

        if self.optimizer:
            best = self._noise_opt(
                xgen=self._theta_restarts(repeat, theta_jitter),
                udist=udist, w=w, tol=tol, verbose=verbose)
            if verbose:
                print(f'Optimization result:\n{best}')
            if not best.success:
                raise RuntimeError(
                    f'Training did not converge, got:\n{best}')
            theta, log_sigma = self._split(best.x)
            self.kernel.theta = theta
            self._sigma = np.exp(log_sigma)

        self._K_train = K = self._gramian(self._sigma ** 2, self._X)
        self._K_inv, _, _ = obj.inverse(K, self.beta, self.device)
        self._weights = self._K_inv @ self._y
        return self

    def predict(self, Z, return_std=False, return_cov=False):
        """Posterior prediction with the learned noise model."""
        if not hasattr(self, '_K_inv'):
            raise RuntimeError('Model not trained.')
        Ks = self._gramian(None, Z, self._X)
        mean = Ks @ self._weights * self._ystd + self._ymean
        if return_std:
            prior = self._gramian(0, Z, diag=True)
            explained = np.einsum('ij,jk,ik->i', Ks, self._K_inv, Ks)
            std = np.sqrt(np.maximum(prior - explained, 0.0))
            return mean, std * self._ystd
        if return_cov:
            prior = self._gramian(0, Z)
            cov = np.maximum(prior - Ks @ self._K_inv @ Ks.T, 0.0)
            return mean, cov * self._ystd ** 2
        return mean

    # -- objective ----------------------------------------------------------

    def log_marginal_likelihood(self, theta_ext, X=None, y=None,
                                eval_gradient=False, clone_kernel=True,
                                verbose=False):
        """Negative LML over [theta..., log sigma...]; both gradient
        blocks come from the Gram-matrix autograd."""
        X = self._X if X is None else X
        y = self._y if y is None else y
        theta, log_sigma = self._split(theta_ext)
        sigma2 = np.exp(2.0 * log_sigma)

        if clone_kernel:
            kernel = self.kernel.clone_with_theta(theta)
        else:
            kernel = self.kernel
            kernel.theta = theta

        if not eval_gradient:
            K = self._gramian(sigma2, X, kernel=kernel)
            return float(obj.negative_log_marginal(K, y, self.beta,
                                                   device=self.device))

        K, dK = self._gramian(sigma2, X, kernel=kernel, jac=True)
        value, (gK,) = obj.negative_log_marginal(
            K, y, self.beta, with_grad=True, device=self.device)
        d_theta = obj.chain_to_theta(gK, dK, theta, self.device)
        d_log_sigma = 2.0 * sigma2 * gK.diagonal()
        grad = np.concatenate((d_theta, d_log_sigma))

        if verbose:
            mprint.table(
                ('logP', '%12.5g', value),
                ('dlogP', '%12.5g', np.linalg.norm(grad)),
            )
        return float(value), grad

    def _noise_opt(self, xgen, udist, w, tol, verbose):
        """Multi-restart L-BFGS over [theta, log sigma] with an L1
        penalty on the noise magnitudes."""
        n = len(self._y)
        if udist is None:
            def udist(k):
                return self._ystd * np.random.lognormal(-1.0, 1.0, k)

        l1_weight = np.concatenate((
            np.zeros(len(self.kernel.theta)), np.full(n, float(w))))
        bounds = np.vstack((
            self.kernel.bounds,
            np.tile(np.log(self.sigma_bounds), (n, 1))))

        def penalized(x):
            value, grad = self.log_marginal_likelihood(
                x, eval_gradient=True, clone_kernel=False,
                verbose=verbose)
            lasso = l1_weight * np.exp(x)
            return value + lasso.sum(), grad + lasso

        attempts = []
        for x0 in xgen:
            if verbose:
                mprint.table_start()
            attempts.append(minimize(
                fun=penalized, method=self.optimizer,
                x0=np.concatenate((x0, np.log(udist(n)))),
                bounds=bounds, jac=True, tol=tol))
        converged = [a for a in attempts if a.success]
        return min(converged or attempts, key=lambda a: a.fun)
