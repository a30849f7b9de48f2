"""Differentiable GP log-posteriors over kernel hyperparameters; counterpart
of ``graphdot_tpu/inference/gp_logprob.py``.

The log-marginal likelihood of a graph-kernel GP becomes a torch log
density over the log hyperparameters that feeds the NUTS, HMC, SMC and VI
samplers of this package, one hyperparameter vector or a batch of them (a
sampler's chains) a call. The Gram and its gradient come from a
:class:`~.gram.GramFactory`, whose ``eval_gradient`` gives dK / d log theta
itself; a ``torch.autograd.Function`` hands it to autograd, where the JAX
module differentiates through ``lax.custom_linear_solve``. The density is
computed in float64 on the kernel's device, as the port's GP regressor
computes its objectives, and returned as float32.
"""
import math

import numpy as np
import torch

from .gram import GramFactory
from ..util.trace import span


def _mvn_logdensity(K, y, alpha):
    """log N(y | 0, K + alpha I) by Cholesky, in float64, for K [..., n, n]
    and y [n]. Where K + alpha I has no Cholesky factor (it is not positive
    definite, or not finite) the density is NaN, as JAX's Cholesky gives,
    without an exception."""
    K = K.to(torch.float64)
    n = y.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K + alpha * eye)
    failed = info != 0
    L = torch.where(failed[..., None, None], eye, L)
    z = torch.linalg.solve_triangular(
        L, y.expand(*K.shape[:-2], n)[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             dim=-1)
    value = -0.5 * (torch.sum(z * z, dim=-1) + logdet
                    + n * math.log(2.0 * math.pi))
    return torch.where(failed, torch.nan, value)


class _Gram(torch.autograd.Function):
    """K(t) of a factory, differentiable in the log hyperparameters t [D]
    or [C, D]: the forward pass asks the factory for dK / d t as well when
    t needs a gradient, and the backward pass contracts the incoming
    gradient of K with it. The two passes run in ``torch.profiler`` ranges
    named ``gp_gram`` and ``gp_gram_backward``."""

    @staticmethod
    def forward(ctx, t, factory, lmin):
        with span('gp_gram'):
            if ctx.needs_input_grad[0]:
                K, dK = factory.gram(t.detach(), lmin=lmin,
                                     eval_gradient=True)
                ctx.save_for_backward(dK)
            else:
                K = factory.gram(t.detach(), lmin=lmin)
        ctx.t_device = t.device
        return K

    @staticmethod
    def backward(ctx, gK):
        with span('gp_gram_backward'):
            dK, = ctx.saved_tensors
            grad = torch.sum(gK[..., None] * dK, dim=(-3, -2))
        return grad.to(ctx.t_device), None, None


class GPRLogProb:
    """Log-posterior of a graph-kernel GPR's hyperparameters.

    logp(t) = log N(y | 0, K(t) + alpha I) + log prior(t), where t is the
    log-scale active hyperparameter vector and K is the (normalized) MLGK
    Gram matrix over the training graphs.

    Parameters
    ----------
    kernel: MarginalizedGraphKernel (its device is where the Grams and the
        density are computed: the card unless it was made with
        ``device='cpu'``).
    X: list of Graph
        Training graphs.
    y: 1-D array
        Training targets (standardized unless normalize_y=False).
    alpha: float
        Diagonal regularization / observation noise.
    normalize: bool
        Cosine-normalize the Gram matrix.
    normalize_y: bool
        Standardize targets.
    prior: callable or None
        Extra log-prior over t, [C, D] -> [C] (defaults to a wide Gaussian
        in log space that keeps the posterior proper).
    prior_scale: float
        Std of the default Gaussian prior on the log hyperparameters.
    lmin: 0 or 1, as the kernel's.
    maxiter: int
        Per-evaluation CG step cap (see ``GramFactory``): bounds the cost of
        log-density evaluations at extreme-tail hyperparameters, where an
        exact solve is pointless (the sampler rejects them) but would
        otherwise run its full n1*n2-step budget.
    """

    def __init__(self, kernel, X, y, alpha=1e-6, normalize=True,
                 normalize_y=True, prior=None, prior_scale=10.0,
                 lmin=0, maxiter=64):
        self.factory = GramFactory(kernel, X, normalize=normalize,
                                   maxiter=maxiter)
        y = np.asarray(y, dtype=np.float64)
        if normalize_y:
            self.ymean, self.ystd = y.mean(), max(y.std(), 1e-300)
        else:
            self.ymean, self.ystd = 0.0, 1.0
        # float32 targets, as the JAX module keeps them, used in float64
        self._y = torch.as_tensor(
            ((y - self.ymean) / self.ystd).astype(np.float32),
            device=kernel.device).double()
        self.alpha = alpha
        self.lmin = lmin
        self.bounds = None
        if prior is None:
            t0 = torch.as_tensor(self.factory.theta0, dtype=torch.float32)

            def prior(t):
                return -0.5 * torch.sum(
                    ((t - t0.to(t.device)) / prior_scale) ** 2, dim=-1)
        self.prior = prior

    @property
    def theta0(self):
        return self.factory.theta0

    @property
    def n_dims(self):
        return self.factory.n_active

    def __call__(self, t):
        """The log posterior at t [D] (a scalar) or at each row of t [C, D]
        ([C]), float32 on t's device, differentiable in t by autograd. Where
        the Gram has no Cholesky factor the value is NaN. The density runs
        in a ``torch.profiler`` range named ``gp_density``."""
        t = torch.as_tensor(t, dtype=torch.float32)
        K = _Gram.apply(t, self.factory, self.lmin)
        with span('gp_density'):
            logp = _mvn_logdensity(K, self._y, self.alpha).to(t.device) \
                + self.prior(t).double()
        return logp.float()

    def value_and_grad(self):
        """A function t -> (logp, d logp / d t) of one t [D] or of each row
        of t [C, D]."""
        def value_and_grad(t):
            with torch.enable_grad():
                t = torch.as_tensor(t, dtype=torch.float32).detach() \
                    .requires_grad_(True)
                logp = self(t)
                grad, = torch.autograd.grad(logp.sum(), t)
            return logp.detach(), grad
        return value_and_grad

    def convergence_diagnostics(self, thetas):
        """Worst relative CG residual ||b - A x|| / ||b|| of the Gram
        solves at one or more log-theta points, one batched Gram.

        The bounded-effort ``maxiter`` cap (see the class docstring)
        silently truncates solves at extreme hyperparameters. Converged
        float32 solves report ~1e-7..1e-5; values orders of magnitude
        above that at points *inside* the posterior's typical set mean
        the cap is biasing log-densities and should be raised.
        Recommended check after sampling: pass a thinned subset of the
        posterior draws and assert the ratios stay near the converged
        baseline (e.g. < 1e-4).
        """
        thetas = np.atleast_2d(np.asarray(thetas, dtype=np.float32))
        return np.asarray(self.factory.gram(
            thetas, lmin=self.lmin, with_residual=True)[1],
            dtype=np.float64)

    def predict_fn(self, Z):
        """A function t -> (mean, var) of the GP posterior at the graphs Z
        given the training set, float64 tensors on the kernel's device."""
        n = len(self.factory.graphs)
        joint = GramFactory(
            self.factory.kernel, list(self.factory.graphs) + list(Z),
            normalize=self.factory.normalize)

        def predict(t):
            Kfull = joint.gram(t, lmin=self.lmin).double()
            K = Kfull[:n, :n] + self.alpha * torch.eye(
                n, dtype=Kfull.dtype, device=Kfull.device)
            Ks = Kfull[n:, :n]
            Kss = torch.diagonal(Kfull[n:, n:])
            L = torch.linalg.cholesky(K)
            Ky = torch.cholesky_solve(self._y[:, None], L)[:, 0]
            mean = Ks @ Ky * self.ystd + self.ymean
            V = torch.cholesky_solve(Ks.T, L)
            var = torch.clamp(Kss - torch.sum(Ks * V.T, dim=1), min=0.0) \
                * self.ystd ** 2
            return mean, var

        return predict
