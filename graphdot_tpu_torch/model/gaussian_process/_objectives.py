"""GP training objectives as functions of the Gram matrix; counterpart of
``graphdot_tpu/model/gaussian_process/_objectives.py``.

Each objective is a scalar torch function of the Gram matrix (for Nystrom,
of the cross and core matrices), run in float64 on the model's device
(:func:`graphdot_tpu_torch.linalg._exec.run`); its matrix gradient comes
from ``torch.autograd`` where the JAX module takes ``jax.value_and_grad``,
and the hyperparameter gradient is one contraction of that gradient with
the kernel jacobian dK. An indefinite Gram falls back from Cholesky to a
positive-clamped eigendecomposition. Inputs and outputs are numpy float64.
"""
import warnings

import numpy as np
import torch

from ...linalg._exec import run
from ...util.trace import span

# ---------------------------------------------------------------------
# inverses
# ---------------------------------------------------------------------


def _by_cholesky(K, rcond):
    del rcond
    L, info = torch.linalg.cholesky_ex(K)
    # NaN where K is not positive definite, as jnp.linalg.cholesky
    L = torch.where(info == 0, L, torch.nan)
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    K_inv = torch.cholesky_solve(eye, L)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return K_inv, logdet


def _eigh(H):
    """Eigendecomposition of the symmetric part of H, as
    ``jnp.linalg.eigh`` takes it (``torch.linalg.eigh`` reads one
    triangle); NaN for a matrix with NaN or Inf entries, which
    ``torch.linalg.eigh`` refuses with an error."""
    H = 0.5 * (H + H.T)
    finite = torch.isfinite(H).all()
    with span('host_sync'):
        finite = bool(finite)
    if not finite:
        nan = torch.full_like(H, torch.nan)
        return nan[0], nan
    return torch.linalg.eigh(H)


def _by_clamped_eigh(K, rcond):
    w, Q = _eigh(K)
    floor = w[-1] * rcond
    w = torch.where(w > floor, w, floor)
    K_inv = (Q / w) @ Q.T
    return K_inv, torch.sum(torch.log(w))


_INVERSES = {'cholesky': _by_cholesky, 'eigh': _by_clamped_eigh}

# ---------------------------------------------------------------------
# scalar objectives
# ---------------------------------------------------------------------


def _nll(K, y, rcond, method):
    """y^T K^-1 y + log|K| (negative log marginal likelihood, up to a
    constant)."""
    K_inv, logdet = _INVERSES[method](K, rcond)
    return y @ (K_inv @ y) + logdet


def _loocv(K, y, rcond, method):
    """Half squared norm of the leave-one-out residuals
    e_i = (K^-1 y)_i / (K^-1)_ii."""
    K_inv, _ = _INVERSES[method](K, rcond)
    e = (K_inv @ y) / torch.diagonal(K_inv)
    return 0.5 * torch.sum(e ** 2)


def _nystrom_nll(Kxc, Kcc, y, rcond, method):
    """Low-rank LML: K ~= F F^T with F = Kxc Kcc^-1/2; the log-det and
    inverse act on the retained spectrum (the pseudo-determinant)."""
    del method
    w, Q = _eigh(Kcc)
    w = torch.maximum(w, w[-1] * rcond)
    F = Kxc @ (Q * torch.rsqrt(w))
    U, s, _ = torch.linalg.svd(F, full_matrices=False)
    s = torch.maximum(s, s[0] * rcond)
    z = (U.T @ y) / s
    return torch.dot(z, z) + 2.0 * torch.sum(torch.log(s))


def _evaluate(fn, mats, y, rcond, with_grad, device):
    """Run an objective with the Cholesky -> clamped-eigh fallback; the
    value, and with ``with_grad`` (value, (gradient per matrix, ...))."""
    n_mats = len(mats)

    def value(method):
        def objective(*args):
            args = [a.requires_grad_(with_grad) if i < n_mats else a
                    for i, a in enumerate(args)]
            with torch.enable_grad():
                v = fn(*args, method=method)
            if not with_grad:
                return v
            finite = torch.isfinite(v)
            with span('host_sync'):
                finite = bool(finite)
            if not finite:
                return v
            return v, torch.autograd.grad(v, args[:n_mats])
        return objective

    for method in ('cholesky', 'eigh'):
        out = run(value(method), *mats, y, rcond, device=device)
        v = out[0] if isinstance(out, tuple) else out
        if np.isfinite(v):
            if method == 'eigh':
                warnings.warn(
                    'Gram matrix not positive definite; continuing with '
                    'a positive-clamped pseudoinverse.')
            return out if with_grad else v
        if fn is _nystrom_nll:
            break  # already eigh-based; nothing to fall back to
    raise np.linalg.LinAlgError(
        'The Gram matrix could not be inverted — it is likely corrupted '
        'by NaNs or Infs.')


def negative_log_marginal(K, y, rcond, with_grad=False, device='cuda'):
    """NLL (and its gradient w.r.t. K) with PD fallback."""
    return _evaluate(_nll, (K,), y, rcond, with_grad, device)


def loocv_error(K, y, rcond, with_grad=False, device='cuda'):
    """Half squared LOOCV residual norm (and its K-gradient)."""
    return _evaluate(_loocv, (K,), y, rcond, with_grad, device)


def nystrom_negative_log_marginal(Kxc, Kcc, y, rcond, with_grad=False,
                                  device='cuda'):
    """Low-rank NLL and, when requested, gradients w.r.t. (Kxc, Kcc)."""
    return _evaluate(_nystrom_nll, (Kxc, Kcc), y, rcond, with_grad, device)

# ---------------------------------------------------------------------
# host-facing helpers
# ---------------------------------------------------------------------


def chain_to_theta(gK, dK, theta_log, device='cuda'):
    """Fold a Gram-matrix gradient through the kernel jacobian (linear
    scale) onto the log-scale hyperparameters: one contraction."""
    return run(lambda g, d, scale: torch.einsum('ij,ijk->k', g, d) * scale,
               gK, dK, np.exp(theta_log), device=device)


def inverse(K, rcond, device='cuda'):
    """(K^-1, log|K|) with Cholesky -> clamped-eigh fallback, plus the
    method that succeeded."""
    for method in ('cholesky', 'eigh'):
        K_inv, logdet = run(_INVERSES[method], K, rcond, device=device)
        if np.isfinite(logdet) and np.isfinite(K_inv).all():
            return K_inv, float(logdet), method
    raise np.linalg.LinAlgError(
        'The Gram matrix could not be inverted — it is likely corrupted '
        'by NaNs or Infs.')
