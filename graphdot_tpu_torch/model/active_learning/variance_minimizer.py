"""Greedy posterior-variance minimization; a copy of
``graphdot_tpu/model/active_learning/variance_minimizer.py`` (numpy
only). The kernel matrix comes from the kernel it is given: a port kernel
computes it on its own device.

Greedily grows a subset so that the GP posterior variance (Nystrom
residual) of the REMAINING samples is minimized. Instead of the
reference's swap-to-front + bordered-inverse updates, the selection runs
as a pivoted-Cholesky-style residual sweep: after each pick the residual
kernel is deflated by a rank-1 outer product, so the posterior covariance
of the unchosen samples is always the residual itself — no row/column
permutations and no explicit inverse.
"""
import numpy as np


class VarianceMinimizer:
    """Subset selector by greedy posterior-variance reduction.

    Parameters
    ----------
    kernel: callable or 'precomputed'
        Symmetric PSD kernel; with 'precomputed', ``__call__`` expects a
        square kernel matrix.
    alpha: float
        Diagonal jitter added before selection.
    kernel_options: dict
    """

    def __init__(self, kernel, alpha=1e-6, kernel_options=None):
        if not (kernel == 'precomputed' or callable(kernel)):
            raise TypeError(
                "kernel must be callable or the string 'precomputed'."
            )
        self.kernel = kernel
        self.alpha = alpha
        self.kernel_options = kernel_options or {}

    def _kernel_matrix(self, X):
        if isinstance(self.kernel, str):
            K = np.array(X, dtype=float)
            if K.ndim != 2 or K.shape[0] != K.shape[1]:
                raise ValueError(
                    'A precomputed kernel matrix must be square.'
                )
        else:
            K = np.array(self.kernel(X, **self.kernel_options), dtype=float)
        return K + self.alpha * np.eye(len(K))

    def __call__(self, X, n):
        """Indices of n greedily chosen samples of X."""
        if len(X) < n:
            raise ValueError(f'Cannot choose {n} out of {len(X)} samples.')
        R = self._kernel_matrix(X)  # residual kernel, deflated in place
        unchosen = np.ones(len(R), dtype=bool)
        chosen = []
        for _ in range(n):
            # The posterior covariance of the unchosen block given the
            # chosen set is exactly the residual restricted to it; score
            # each candidate by its residual row-sum over that block.
            score = R @ unchosen
            score[~unchosen] = -np.inf
            pick = int(np.argmax(score))
            chosen.append(pick)
            unchosen[pick] = False
            # rank-1 deflation: R <- R - R[:,p] R[p,:] / R[p,p]
            col = R[:, pick]
            R -= np.outer(col, col) / col[pick]
        return chosen
