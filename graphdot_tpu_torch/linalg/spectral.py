"""Spectral (eigendecomposition-based) Hermitian matrix functions;
counterpart of ``graphdot_tpu/linalg/spectral.py``.

The eigendecomposition runs in float64 on the caller's device
(:func:`._exec.eigh`); the filtering of the eigenvalues, which changes
shapes, happens on the host. ``pinvh`` keeps only positive eigenvalues, so
that a nearly singular Gram matrix with elementwise noise cannot give a
runaway log-likelihood term.
"""
import numpy as np

from ._exec import eigh


class Spectrum:
    """Eigendecomposition of a Hermitian matrix with optional filtering.

    Parameters
    ----------
    H: Hermitian ndarray.
    rcond: float or None
        Relative eigenvalue cutoff ``rcond * max(eigenvalue)``.
    mode: 'truncate' drops eigenpairs below the cutoff; 'clamp' lifts
        their eigenvalues up to it.
    positive: bool
        Apply the cutoff against positive eigenvalues only (drops the
        negative tail entirely under 'truncate').
    device: where the decomposition runs, the card (``'cuda'``) unless the
        caller asks for the CPU.
    """

    def __init__(self, H, rcond=None, mode='truncate', positive=False,
                 device='cuda'):
        values, vectors = eigh(H, device=device)
        if rcond is not None:
            cutoff = values[-1] * rcond
            above = values > cutoff
            if mode == 'truncate':
                values = values[above]
                vectors = vectors[:, above]
            elif mode == 'clamp':
                values = np.where(above, values, cutoff) if positive \
                    else np.maximum(values, cutoff)
            else:
                raise RuntimeError(
                    f"Unknown pseudoinverse mode '{mode}'.")
        self.values = values
        self.vectors = vectors

    def function(self, f, symmetric=True):
        """Assemble ``Q f(a) Q^T`` (or ``Q f(a)`` when not symmetric)."""
        scaled = self.vectors * f(self.values)
        return scaled @ self.vectors.T if symmetric else scaled

    @property
    def logdet(self):
        return float(np.sum(np.log(self.values)))


def powerh(H, p, rcond=None, mode='truncate', return_symmetric=True,
           return_eigvals=False, device='cuda'):
    r"""Fractional power :math:`H^p` of a Hermitian matrix.

    Raises ``numpy.linalg.LinAlgError`` when a non-positive spectrum makes
    the requested power ill-defined (p < 1, p != 0). With
    ``return_symmetric=False`` only the half-transform ``Q a^p`` is
    returned, the form Nystrom models multiply cross-kernels against.
    """
    s = Spectrum(H, rcond=rcond, mode=mode, device=device)
    if p < 1 and p != 0 and np.any(s.values <= 0):
        raise np.linalg.LinAlgError(
            f'Cannot raise a non-positive-definite matrix to the power '
            f'{p}.')
    Hp = s.function(lambda a: a ** p, symmetric=return_symmetric)
    return (Hp, s.values) if return_eigvals else Hp


def pinvh(H, rcond=1e-10, mode='truncate', return_nlogdet=False,
          device='cuda'):
    """Pseudoinverse of a Hermitian matrix over its positive eigenspace,
    optionally with the log-determinant of the retained spectrum."""
    s = Spectrum(H, rcond=rcond, mode=mode, positive=True, device=device)
    H_inv = s.function(lambda a: 1.0 / a)
    return (H_inv, s.logdet) if return_nlogdet else H_inv
