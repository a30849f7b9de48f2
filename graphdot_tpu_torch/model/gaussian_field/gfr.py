"""Gaussian field regressor for semi-supervised label propagation
(Zhu, Ghahramani & Lafferty, ICML 2003); counterpart of
``graphdot_tpu/model/gaussian_field/gfr.py``.

The harmonic solve and both training losses are float64 torch functions
of the weight matrices, run on the model's ``device``
(:func:`graphdot_tpu_torch.linalg._exec.run`); their gradients w.r.t. the
weight matrices come from ``torch.func.grad_and_value`` where the JAX
module takes ``jax.value_and_grad``, and are contracted against the
weight jacobian on the host. A singular Laplacian gives a NaN solve (as
``jnp.linalg.solve`` gives a non-finite one), which ``predict`` answers
with the JAX module's least-squares fallback. What differs from the JAX
class: ``device``.
"""
import functools
import warnings

import numpy as np
import torch
from scipy.optimize import minimize

from ...linalg._exec import run
from ...util.printer import markdown as mprint


# ---------------------------------------------------------------------
# field computations on tensors
# ---------------------------------------------------------------------

def _solve(A, B):
    """A^-1 B, NaN where A is singular."""
    x, info = torch.linalg.solve_ex(A, B)
    return torch.where(info == 0, x, torch.nan)


def _laplacian(W_uu, W_ul):
    degree = W_uu.sum(dim=1) + W_ul.sum(dim=1)
    return torch.diag(degree) - W_uu


def _field(W_uu, W_ul, f_l):
    """Harmonic interpolation f_u = (D - W_uu)^-1 W_ul f_l."""
    return _solve(_laplacian(W_uu, W_ul), (W_ul @ f_l)[:, None])[:, 0]


def _field_and_influence(W_uu, W_ul, f_l):
    influence = _solve(_laplacian(W_uu, W_ul), W_ul)
    return influence @ f_l, influence


def _entropy_loss(W_uu, W_ul, f_l):
    """Mean binary entropy of the harmonic predictions."""
    z = torch.clamp(_field(W_uu, W_ul, f_l), 1e-7, 1.0 - 1e-7)
    return -torch.mean(z * torch.log(z) + (1.0 - z) * torch.log1p(-z))


def _loocv_loss(W, y, *, p):
    """p-norm of the one-step LOOCV residuals e = y - (W y) / deg."""
    e = y - (W @ y) / W.sum(dim=1)
    return torch.mean(torch.abs(e) ** p) ** (1.0 / p)


_entropy_gv = torch.func.grad_and_value(_entropy_loss, argnums=(0, 1))


def _loocv_forms(p):
    bound = functools.partial(_loocv_loss, p=p)
    return bound, torch.func.grad_and_value(bound)


class GaussianFieldRegressor:
    """Semi-supervised prediction of missing continuous node labels via
    harmonic interpolation ``f_u = (D - W_uu)^-1 W_ul f_l``.

    Parameters
    ----------
    weight: callable or 'precomputed'
        Converts data (or index sets) to edge weights; 'precomputed'
        treats X itself as the weight matrix.
    optimizer: str, True, None, or callable
        scipy.optimize.minimize method; True selects L-BFGS-B.
    smoothing: float in [0, 1)
        Regularization added uniformly to the weights.
    device: torch device (or its name) of the solves and the losses: the
        card (``'cuda'``) unless the caller asks for ``'cpu'``.
    """

    def __init__(self, weight, optimizer=None, smoothing=1e-3,
                 device='cuda'):
        assert smoothing >= 0, 'Smoothing must be no less than 0.'
        self.weight = weight
        self.optimizer = 'L-BFGS-B' if optimizer is True else optimizer
        self.smoothing = smoothing
        self.device = device

    def _run(self, fn, *arrays):
        return run(fn, *arrays, device=self.device)

    # -- weight assembly ----------------------------------------------------

    def _weights_between(self, A, B=None, jac=False):
        """Smoothed weight matrix (and log-scale jacobian) between data
        subsets. Precomputed weights are sliced by the callers directly."""
        args = (A,) if B is None else (A, B)
        if jac:
            W, dW = self.weight(*args, eval_gradient=True)
            return W + self.smoothing, dW
        return self.weight(*args) + self.smoothing

    def _split_field(self, X, y, jac=False):
        """(labeled mask, f_l, W_uu, W_ul [, dW_uu, dW_ul])."""
        labeled = np.isfinite(y)
        f_l = y[labeled]
        if labeled.all():
            raise RuntimeError(
                'All samples are labeled, no predictions will be made.')
        if isinstance(self.weight, str) and self.weight == 'precomputed':
            if jac:
                raise RuntimeError(
                    'Precomputed weights have no hyperparameters to '
                    'differentiate.')
            W_uu = X[np.ix_(~labeled, ~labeled)] + self.smoothing
            W_ul = X[np.ix_(~labeled, labeled)] + self.smoothing
            return labeled, f_l, W_uu, W_ul
        if jac:
            W_uu, dW_uu = self._weights_between(X[~labeled], jac=True)
            W_ul, dW_ul = self._weights_between(
                X[~labeled], X[labeled], jac=True)
            return labeled, f_l, W_uu, W_ul, dW_uu, dW_ul
        W_uu = self._weights_between(X[~labeled])
        W_ul = self._weights_between(X[~labeled], X[labeled])
        return labeled, f_l, W_uu, W_ul

    # -- prediction -------------------------------------------------------

    def predict(self, X, y, return_influence=False):
        """Fill in the unlabeled (None/NaN) entries of y; optionally also
        return the labeled-onto-unlabeled influence matrix."""
        assert len(X) == len(y)
        X = np.asarray(X)
        y = np.asarray(y, dtype=float)

        labeled, f_l, W_uu, W_ul = self._split_field(X, y)
        if return_influence:
            f_u, influence = self._run(_field_and_influence, W_uu, W_ul,
                                       f_l)
        else:
            f_u = self._run(_field, W_uu, W_ul, f_l)
        if not np.isfinite(f_u).all():
            warnings.warn(
                'The graph Laplacian is singular; using a least-squares '
                'solution. Some edge weights may be invalid.')
            degree = W_uu.sum(axis=1) + W_ul.sum(axis=1)
            pinv = np.linalg.pinv(np.diag(degree) - W_uu)
            influence = pinv @ W_ul
            f_u = influence @ f_l

        z = y.copy()
        z[~labeled] = f_u
        return (z, influence) if return_influence else z

    def fit(self, X, y, loss='loocv2', tol=1e-5, repeat=1,
            theta_jitter=1.0, verbose=False):
        """Optimize the weight hyperparameters under the given loss
        ('ale'/'average-label-entropy', 'loocv1' or 'loocv2').
        Returns self."""
        assert len(X) == len(y)
        X = np.asarray(X)
        y = np.asarray(y, dtype=float)

        if not (self.optimizer and hasattr(self.weight, 'theta')):
            return self

        try:
            objective = {
                'ale': self.average_label_entropy,
                'average-label-entropy': self.average_label_entropy,
                'loocv1': self.loocv_error_1,
                'loocv2': self.loocv_error_2,
            }[loss]
        except KeyError:
            raise RuntimeError(f"Unknown loss function '{loss}'")

        starts = [np.copy(self.weight.theta)]
        starts += [
            starts[0] + theta_jitter * np.random.randn(len(starts[0]))
            for _ in range(int(repeat) - 1)
        ]
        attempts = []
        for x0 in starts:
            if verbose:
                mprint.table_start()
            attempts.append(minimize(
                fun=lambda t: objective(
                    X, y, theta=t, eval_gradient=True, verbose=verbose),
                x0=x0, method=self.optimizer, jac=True,
                bounds=self.weight.bounds, tol=tol))
        converged = [a for a in attempts if a.success]
        if not converged:
            raise RuntimeError(
                f'Optimizer did not converge, got:\n{attempts}')
        best = min(converged, key=lambda a: a.fun)
        if verbose:
            print(f'Optimization result:\n{best}')
        self.weight.theta = best.x
        return self

    def fit_predict(self, X, y, loss='average-label-entropy', tol=1e-5,
                    repeat=1, theta_jitter=1.0, return_influence=False,
                    verbose=False):
        """Train, then predict the unlabeled nodes."""
        self.fit(X, y, loss=loss, tol=tol, repeat=repeat,
                 theta_jitter=theta_jitter, verbose=verbose)
        return self.predict(X, y, return_influence=return_influence)

    # -- losses -------------------------------------------------------------

    def average_label_entropy(self, X, y, theta=None, eval_gradient=False,
                              verbose=False):
        """Mean binary entropy of the harmonic predictions (labels must
        be 0/1), with its autograd gradient w.r.t. the log-scale weight
        hyperparameters when requested."""
        if theta is not None:
            self.weight.theta = theta
        X = np.asarray(X)
        y = np.asarray(y, dtype=float)

        if not eval_gradient:
            _, f_l, W_uu, W_ul = self._split_field(X, y)
            return float(self._run(_entropy_loss, W_uu, W_ul, f_l))

        _, f_l, W_uu, W_ul, dW_uu, dW_ul = self._split_field(
            X, y, jac=True)
        (gUU, gUL), value = self._run(_entropy_gv, W_uu, W_ul, f_l)
        grad = (
            np.einsum('mn,mnj->j', gUU, dW_uu)
            + np.einsum('mn,mnj->j', gUL, dW_ul)
        )
        if verbose:
            mprint.table(
                ('Avg.Entropy', '%12.5g', value),
                ('Gradient', '%12.5g', np.linalg.norm(grad)),
            )
        return float(value), grad

    def loocv_error(self, X, y, p=2, theta=None, eval_gradient=False,
                    verbose=False):
        """One-step leave-one-out error of the labeled samples in p-norm
        under the transition matrix P = D^-1 W, with its autograd
        gradient when requested."""
        if theta is not None:
            self.weight.theta = theta
        X = np.asarray(X)
        y = np.asarray(y, dtype=float)
        labeled = np.isfinite(y)
        y = y[labeled]

        value_fn, grad_fn = _loocv_forms(float(p))
        if eval_gradient:
            W, dW = self._weights_between(X[labeled], jac=True)
            gW, value = self._run(grad_fn, W, y)
            grad = np.einsum('mn,mnj->j', gW, dW)
            if verbose:
                mprint.table(
                    ('LOOCV Err.', '%12.5g', value),
                    ('Gradient', '%12.5g', np.linalg.norm(grad)),
                )
            return float(value), grad

        if isinstance(self.weight, str) and self.weight == 'precomputed':
            W = X[np.ix_(labeled, labeled)] + self.smoothing
        else:
            W = self._weights_between(X[labeled])
        return float(self._run(value_fn, W, y))

    def loocv_error_1(self, X, y, **kwargs):
        """LOOCV error in L1 norm."""
        return self.loocv_error(X, y, p=1, **kwargs)

    def loocv_error_2(self, X, y, **kwargs):
        """LOOCV error in L2 norm."""
        return self.loocv_error(X, y, p=2, **kwargs)
