"""Greedy determinant maximization by pivoted Cholesky; a copy of
``graphdot_tpu/model/active_learning/determinant_maximizer.py`` (numpy
only). The kernel matrix comes from the kernel it is given: a port kernel
computes it on its own device.

The selection follows the D-optimal greedy rule: at each step pick the
sample with the largest *residual conditional variance* given the picks
so far (the Schur complement diagonal), which multiplies the running
determinant of the selected submatrix by exactly that amount. One
pivoted-Cholesky column update per pick — O(N n) total instead of the reference's O(N^2)
deflation per step — and all selections are provably locally optimal for
log-det.
"""
import numpy as np


class DeterminantMaximizer:
    """Select a subset whose kernel submatrix has (approximately) maximal
    determinant — samples as linearly independent as possible in the
    RKHS.

    Parameters
    ----------
    kernel: callable or 'precomputed'
        Symmetric PSD kernel, or 'precomputed' to pass a square kernel
        matrix directly to ``__call__``.
    kernel_options: dict
    """

    def __init__(self, kernel, kernel_options=None):
        assert kernel == 'precomputed' or callable(kernel)
        self.kernel = kernel
        self.kernel_options = kernel_options or {}

    def __call__(self, X, n):
        """Indices of n greedily chosen samples of X."""
        assert len(X) >= n
        if isinstance(self.kernel, str) and self.kernel == 'precomputed':
            assert (
                isinstance(X, np.ndarray) and X.ndim == 2
                and X.shape[0] == X.shape[1]
            ), 'A precomputed kernel matrix must be square.'
            K = np.asarray(X, dtype=float)
        else:
            K = np.asarray(
                self.kernel(X, **self.kernel_options), dtype=float)
        return self._choose(K, n)

    @staticmethod
    def _choose(K, n):
        """Greedy log-det picks via pivoted Cholesky."""
        N = len(K)
        residual = K.diagonal().astype(float).copy()
        basis = np.zeros((N, n))
        picks = []
        for step in range(n):
            i = int(np.argmax(residual))
            picks.append(i)
            pivot = np.sqrt(max(residual[i], 1e-300))
            column = (
                K[:, i] - basis[:, :step] @ basis[i, :step]
            ) / pivot
            basis[:, step] = column
            residual -= column ** 2
            residual[picks] = -np.inf
        return picks
