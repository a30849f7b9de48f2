"""Marginalized graph kernel evaluated at an explicit list of graph-index
pairs; counterpart of ``graphdot_tpu/experimental/alternative_mgk.py``.

The job list goes through ``MarginalizedGraphKernel._solve_jobs`` (a
:class:`~graphdot_tpu_torch.kernel.marginalized._kernel.JobPlan` on the
kernel's device), so no separate backend is needed.
"""
import numpy as np

from ..kernel.marginalized import MarginalizedGraphKernel


class AltMarginalizedGraphKernel(MarginalizedGraphKernel):
    """Evaluates K only at the requested (i, j) pairs.

    Parameters are inherited from MarginalizedGraphKernel (``device``
    included: the card unless the caller asks for the CPU).
    """

    def __call__(self, X, ij, lmin=0, timing=False):
        """Compute a vector of similarities for the given pair indices.

        Parameters
        ----------
        X: list of N graphs with identical feature signatures.
        ij: list of (i, j) int pairs into X.
        lmin: 0 or 1.
        timing: kept for the JAX signature; prints nothing.

        Returns
        -------
        gramian: 1-D ndarray with the same length as ij.
        """
        self._check_types(list(X))
        ij = np.asarray(ij, dtype=np.int64)
        raw = self._solve_jobs(
            list(X), ij[:, 0], ij[:, 1], nodal=False, lmin=lmin,
            eval_gradient=False
        )
        return np.asarray(raw).astype(self.element_dtype)
