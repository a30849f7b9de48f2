"""Cholesky factor-and-solve in float64 on a torch device; counterpart of
``graphdot_tpu/linalg/cholesky.py``.

The factor is computed once and kept on the device; each ``solver @ b``
is one ``cholesky_solve`` there. An indefinite matrix gives a NaN factor
(as ``jnp.linalg.cholesky`` does), which the constructor turns into
``numpy.linalg.LinAlgError``, the caller contract of the JAX module.
"""
import numpy as np
import torch

from ..kernel.marginalized._backend import resolve_device
from ._exec import _cho_apply, _cholesky, _to_numpy, as_tensor


class CholSolver:
    """Factorizes ``A = L L^T`` once; ``solver @ b`` then solves.
    ``device``: the card (``'cuda'``) unless the caller asks for the
    CPU."""

    def __init__(self, A, device='cuda'):
        self.device = resolve_device(device)
        factor = _cholesky(as_tensor(A, self.device))
        if not bool(torch.isfinite(factor).all()):
            raise np.linalg.LinAlgError(
                'Matrix is not positive definite.')
        self._factor = factor

    def __matmul__(self, b):
        return _to_numpy(_cho_apply(self._factor, as_tensor(b, self.device)))

    def todense(self):
        return self @ np.eye(len(self._factor))

    def diagonal(self):
        return self.todense().diagonal()


def chol_solve(A, b, device='cuda'):
    """One-shot ``A^-1 b`` through a Cholesky factorization."""
    return CholSolver(A, device) @ b
