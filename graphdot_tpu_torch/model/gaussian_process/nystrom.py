"""Nystrom low-rank approximate GPR; counterpart of
``graphdot_tpu/model/gaussian_process/nystrom.py``.

The low-rank LML is one float64 torch function of (Kxc, Kcc) on the
model's device (:func:`._objectives.nystrom_negative_log_marginal`):
eigh-whiten the core, SVD the whitened cross factor, read the
pseudo-determinant off the spectrum. Its hyperparameter gradient is
``torch.autograd`` contracted against the kernel jacobians. The factored
algebra of the prediction (:mod:`graphdot_tpu_torch.linalg.low_rank`)
runs on the same device. For a graph kernel the cross Gram Kxc is a
two-sided call ``kernel(X, C)``, which the kernel serves from a factory
cached over X and C, so the objective's evaluations pack the graphs once.
What differs from the JAX class: ``device``.
"""
import warnings

import numpy as np

from ...linalg import low_rank as lr
from ...linalg.spectral import powerh
from ...util.printer import markdown as mprint
from ...util.trace import spanned
from . import _objectives as obj
from .base import GaussianProcessRegressorBase


class LowRankApproximateGPR(GaussianProcessRegressorBase):
    r"""GPR accelerated by the Nystrom approximation
    :math:`K \approx K_{xc} K_{cc}^{-1} K_{cx}` over a core set C; no
    N-by-N matrix is ever materialized.

    Parameters
    ----------
    kernel: kernel instance
    alpha: float > 0
        Diagonal regularization of the core matrix.
    beta: float > 0
        Eigenvalue/singular-value cutoff of the low-rank pseudoinverse.
    optimizer, normalize_y, regularization, kernel_options: see
        :class:`GaussianProcessRegressor`.
    device: torch device (or its name) of the objective's and the
        prediction's linear algebra: the card (``'cuda'``) unless the
        caller asks for ``'cpu'``.
    """

    def __init__(self, kernel, alpha=1e-7, beta=1e-7, optimizer=None,
                 normalize_y=False, regularization='+', kernel_options={},
                 device='cuda'):
        super().__init__(
            kernel, normalize_y=normalize_y, regularization=regularization,
            kernel_options=kernel_options, device=device)
        self.alpha = alpha
        self.beta = beta
        self.optimizer = 'L-BFGS-B' if optimizer is True else optimizer

    @property
    def C(self):
        """The core samples spanning the low-rank subspace."""
        if not hasattr(self, '_C'):
            raise AttributeError(
                'Core samples do not exist. Please provide using fit().')
        return self._C

    @C.setter
    def C(self, samples):
        self._C = samples

    def _whitener(self, Kcc):
        """The half transform ``Kcc^-1/2`` (columns only), strict first,
        then clamped at ``beta`` with a warning."""
        try:
            return powerh(Kcc, -0.5, return_symmetric=False,
                          device=self.device)
        except np.linalg.LinAlgError:
            warnings.warn(
                'Core matrix singular; consider increasing alpha. '
                'Falling back to a clamped pseudoinverse.')
            return powerh(Kcc, -0.5, rcond=self.beta, mode='clamp',
                          return_symmetric=False, device=self.device)

    def _spectral(self, F):
        """The clamped spectral form of ``F F^T`` on the model's device."""
        return lr.dot(F, rcond=self.beta, mode='clamp', device=self.device)

    # -- training ---------------------------------------------------------

    def fit(self, C, X, y, loss='likelihood', tol=1e-5, repeat=1,
            theta_jitter=1.0, verbose=False):
        """Train on core set C and data (X, y). Returns self."""
        self.C = C
        self.X = X
        self.y = y

        if self.optimizer:
            if loss != 'likelihood':
                raise RuntimeError(
                    f"Loss '{loss}' is not available for the low-rank "
                    'model (use likelihood).')
            best = self._hyper_opt(
                method=self.optimizer,
                fun=lambda t: self.log_marginal_likelihood(
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

        self._whiten_half = self._whitener(self._gramian(self.alpha, self._C))
        Kxc = self._gramian(None, self._X, self._C)[self._y_mask]
        self._F_train = Kxc @ self._whiten_half
        self._K_pinv = self._spectral(self._F_train).pinv()
        self._weights = self._K_pinv @ self._y
        return self

    # -- prediction -------------------------------------------------------

    def predict(self, Z, return_std=False, return_cov=False):
        """Posterior mean (and std/cov) through the factored kernel."""
        if not hasattr(self, '_K_pinv'):
            raise RuntimeError('Model not trained.')
        Fzc = self._gramian(None, Z, self._C) @ self._whiten_half
        Kzx = lr.dot(Fzc, self._F_train.T, device=self.device)

        mean = Kzx @ self._weights * self._ystd + self._ymean
        if return_std:
            prior = self._gramian(self.alpha, Z, diag=True)
            explained = (Kzx @ self._K_pinv @ Kzx.T).diagonal()
            std = np.sqrt(np.maximum(prior - explained, 0.0))
            return mean, std * self._ystd
        if return_cov:
            prior = self._gramian(self.alpha, Z)
            cov = np.maximum(
                prior - (Kzx @ self._K_pinv @ Kzx.T).todense(), 0.0)
            return mean, cov * self._ystd ** 2
        return mean

    def predict_loocv(self, Z, z, return_std=False, method='auto'):
        """Leave-one-out predictions on set Z; 'ridge-like' is stabler
        for small full-rank cores, 'gpr-like' for larger ones."""
        assert len(Z) == len(z)
        z = np.asarray(z, dtype=float)
        if self.normalize_y:
            z_mean, z_std = z.mean(), z.std()
            z = (z - z_mean) / z_std
        else:
            z_mean, z_std = 0.0, 1.0

        if not hasattr(self, '_whiten_half'):
            raise RuntimeError('Model not trained.')
        Kzc = self._gramian(None, Z, self._C)

        if method == 'auto':
            # an eigenvalue of Kzc^T Kzc below alpha signals rank
            # deficiency, for which the gpr-like form is the safe choice
            smallest = np.linalg.eigvalsh(Kzc.T @ Kzc)[0] + self.alpha
            method = 'ridge-like' if smallest > self.alpha else 'gpr-like'

        if method == 'ridge-like':
            if return_std:
                raise NotImplementedError(
                    'LOOCV std is unavailable with the ridge-like method.')
            G = Kzc.T @ Kzc + self.alpha * np.eye(len(self._C))
            P = Kzc @ powerh(G, -0.5, return_symmetric=False,
                             device=self.device)
            hat = lr.dot(P, device=self.device)
            loo = z - (z - hat @ z) / (1.0 - hat.diagonal())
        elif method == 'gpr-like':
            F = Kzc @ self._whiten_half
            K_inv = self._spectral(F).pinv()
            precision = K_inv.diagonal()
            loo = z - (K_inv @ z) / precision
            if return_std:
                std = np.sqrt(1.0 / np.maximum(precision, 1e-14))
                return loo * z_std + z_mean, std * z_std
        else:
            raise RuntimeError(f'Unknown method {method} for '
                               'predict_loocv.')
        return loo * z_std + z_mean

    # -- objective ----------------------------------------------------------

    @spanned('gp_objective')
    def log_marginal_likelihood(self, theta=None, C=None, X=None, y=None,
                                eval_gradient=False, clone_kernel=True,
                                verbose=False):
        """Low-rank negative LML; gradients are autograd w.r.t.
        (Kxc, Kcc) folded through the kernel jacobians."""
        theta = self.kernel.theta if theta is None else theta
        C = self._C if C is None else C
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

        if eval_gradient:
            Kxc, dKxc = self._gramian(None, X, C, kernel=kernel, jac=True)
            Kcc, dKcc = self._gramian(self.alpha, C, kernel=kernel,
                                      jac=True)
            Kxc, dKxc = Kxc[y_mask], dKxc[y_mask]
            value, (gXC, gCC) = obj.nystrom_negative_log_marginal(
                Kxc, Kcc, y, self.beta, with_grad=True, device=self.device)
            grad = (obj.chain_to_theta(gXC, dKxc, theta, self.device)
                    + obj.chain_to_theta(gCC, dKcc, theta, self.device))
            if verbose:
                mprint.table(
                    ('logP', '%12.5g', value),
                    ('dlogP', '%12.5g', np.linalg.norm(grad)),
                )
            return float(value), grad

        Kxc = self._gramian(None, X, C, kernel=kernel)[y_mask]
        Kcc = self._gramian(self.alpha, C, kernel=kernel)
        return float(obj.nystrom_negative_log_marginal(
            Kxc, Kcc, y, self.beta, device=self.device))
