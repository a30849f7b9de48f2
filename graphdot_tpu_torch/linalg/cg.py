"""Conjugate-gradient solve-operator in float64 on a torch device;
counterpart of ``graphdot_tpu/linalg/cg.py``.

The iteration is that of ``jax.scipy.sparse.linalg.cg``, which the JAX
module runs: no preconditioner, x0 = 0, the inner products over every
entry of b (a matrix of right-hand sides is one system in the Frobenius
inner product), stop when |r|^2 <= max(rtol^2 |b|^2, atol^2) or after
``maxiter`` steps (default ``10 * b.size``). Each ``@`` application runs
CG from scratch; nothing is precomputed.
"""
import numpy as np
import torch

from ..kernel.marginalized._backend import resolve_device
from ._exec import _to_numpy, as_tensor


def _cg(A, b, rtol, atol, maxiter):
    """x with A x ~= b: the unpreconditioned CG of
    ``jax.scipy.sparse.linalg.cg`` on tensors."""
    bs = torch.sum(b * b)
    target = torch.maximum(rtol ** 2 * bs, torch.tensor(
        atol ** 2, dtype=b.dtype, device=b.device))
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    gamma = torch.sum(r * r)
    for _ in range(maxiter):
        if not bool(gamma > target):
            break
        Ap = A @ p
        alpha = gamma / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_next = torch.sum(r * r)
        p = r + (gamma_next / gamma) * p
        gamma = gamma_next
    return x


class CGSolver:
    """Iterative ``A x = b`` solve on each ``@`` application.

    Parameters
    ----------
    A: square matrix
    rtol, atol: float
        Convergence thresholds on the residual norm.
    maxiter: int or None
        Iteration cap (``jax.scipy.sparse.linalg.cg``'s default,
        ten times the size of b, when None).
    device: torch device (or its name): the card (``'cuda'``) unless the
        caller asks for the CPU.
    """

    def __init__(self, A, rtol=1e-7, atol=0.0, maxiter=None, device='cuda'):
        self.A = np.asarray(A)
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.maxiter = maxiter if maxiter is None else int(maxiter)
        self.device = resolve_device(device)

    def __matmul__(self, b):
        b = np.asarray(b)
        maxiter = 10 * b.size if self.maxiter is None else self.maxiter
        x = _to_numpy(_cg(as_tensor(self.A, self.device),
                          as_tensor(b, self.device), self.rtol, self.atol,
                          maxiter))
        residual = np.linalg.norm(self.A @ x - b)
        bound = max(self.rtol * np.linalg.norm(b), self.atol)
        if not np.isfinite(residual) or (
                bound > 0 and residual > 10 * bound):
            raise RuntimeError(
                f'CG did not converge: |r| = {residual:.3g} '
                f'(target {bound:.3g}).')
        return x

    def todense(self):
        """``A^-1`` as a dense matrix (one CG solve over its columns)."""
        return self @ np.eye(self.A.shape[0])

    def diagonal(self):
        return self.todense().diagonal()
