"""Factored ("low-rank") matrix algebra on a torch device; counterpart of
``graphdot_tpu/linalg/low_rank.py``.

* :class:`Factored` holds a square matrix as a sum of tall-skinny products
  ``sum_k L_k @ R_k``. Addition, subtraction, transposition and
  composition stay in this form, so Nystrom-style models never
  materialize an N-by-N matrix.
* :class:`Spectral` is the symmetric PSD case: an orthonormal basis and
  per-direction weights ``(U, s)`` representing ``U diag(s^2) U^T``; the
  pseudoinverse, log-determinant and powers act on ``s``.

Where the port differs from the JAX module: the factors are float64
tensors on one device (the card unless the caller asks for the CPU), so
every product, reduction and decomposition runs there; what leaves the
algebra (``M @ array``, ``diagonal``, ``todense``, ``quadratic``) comes
back as numpy. The regularized :func:`pinvh` draws its start block from
``np.random.default_rng(seed)`` on the host as the JAX module does, so
both iterate from the same block, and runs the subspace iteration on the
device.
"""
import numpy as np
import torch

from ..kernel.marginalized._backend import resolve_device
from ._exec import _to_numpy, as_tensor


def _terms_of(other):
    if isinstance(other, Factored):
        return other.terms
    raise TypeError(f'Cannot combine Factored with {type(other)}.')


class Factored:
    """A square matrix held as ``sum_k L_k @ R_k``.

    ``terms`` is a sequence of (L, R) pairs with shapes (n, k_i) and
    (k_i, n), as arrays or tensors; they are kept as float64 tensors on
    ``device`` (the card unless the caller asks for the CPU).
    """

    def __init__(self, terms, device='cuda'):
        self.device = resolve_device(device)
        self.terms = [(as_tensor(L, self.device), as_tensor(R, self.device))
                      for L, R in terms]

    def __repr__(self):
        return ' + '.join(
            f'[{L.shape[0]}x{L.shape[1]} @ {R.shape[0]}x{R.shape[1]}]'
            for L, R in self.terms
        )

    def _like(self, terms):
        return Factored(terms, self.device)

    # -- linear structure ------------------------------------------------

    @property
    def T(self):
        return self._like([(R.T, L.T) for L, R in self.terms])

    def __neg__(self):
        return self._like([(-L, R) for L, R in self.terms])

    def __add__(self, other):
        return self._like(self.terms + _terms_of(other))

    def __sub__(self, other):
        return self._like(self.terms + (-other).terms)

    def __matmul__(self, other):
        if isinstance(other, Factored):
            # contract through the small k x k inner blocks
            return self._like([
                (La @ (Ra @ Lb), Rb)
                for La, Ra in self.terms for Lb, Rb in other.terms
            ])
        other = as_tensor(other, self.device)
        return _to_numpy(sum(L @ (R @ other) for L, R in self.terms))

    # -- reductions (never materialize n x n) ----------------------------

    def diagonal(self):
        return _to_numpy(sum(
            torch.einsum('ik,ki->i', L, R) for L, R in self.terms))

    def trace(self):
        return float(self.diagonal().sum())

    def quadratic(self, a, b):
        """``a @ M @ b`` without forming M."""
        a, b = as_tensor(a, self.device), as_tensor(b, self.device)
        return _to_numpy(sum((a @ L) @ (R @ b) for L, R in self.terms))

    def quadratic_diag(self, a, b):
        """``diag(a @ M @ b)`` without forming M."""
        a, b = as_tensor(a, self.device), as_tensor(b, self.device)
        return _to_numpy(sum(
            torch.einsum('ik,ki->i', a @ L, R @ b) for L, R in self.terms))

    def todense(self):
        return _to_numpy(sum(L @ R for L, R in self.terms))


class Spectral(Factored):
    """Symmetric PSD factored matrix ``U diag(s^2) U^T``.

    ``U`` is column-orthonormal; ``s`` carries the square roots of the
    eigenvalues, so ``root = U * s`` satisfies ``M = root @ root.T``.
    """

    def __init__(self, U, s, device='cuda'):
        self.device = resolve_device(device)
        self.U = as_tensor(U, self.device)
        self.s = as_tensor(s, self.device)

    @classmethod
    def from_root(cls, X, rcond=0, mode='truncate', device='cuda'):
        """Spectral form of ``X @ X.T`` from the SVD of X, filtering
        singular values below ``rcond * max`` ('truncate' drops them,
        'clamp' raises them to the cutoff)."""
        device = resolve_device(device)
        U, s, _ = torch.linalg.svd(as_tensor(X, device), full_matrices=False)
        floor = s[0] * rcond
        if mode == 'truncate':
            keep = s >= floor
            U, s = U[:, keep], s[keep]
        elif mode == 'clamp':
            s = torch.maximum(s, floor)
        else:
            raise RuntimeError(
                f"Unknown spectral approximation mode '{mode}'.")
        return cls(U, s, device)

    @property
    def root(self):
        return self.U * self.s

    @property
    def terms(self):
        root = self.root
        return [(root, root.T)]

    @property
    def T(self):
        return self

    def diagonal(self):
        root = self.root
        return _to_numpy(torch.einsum('ik,ik->i', root, root))

    def pinv(self):
        return Spectral(self.U, 1.0 / self.s, self.device)

    def logdet(self):
        return 2.0 * float(torch.sum(torch.log(self.s)))

    def cond(self):
        return float((self.s.max() / self.s.min()) ** 2)

    def __pow__(self, exponent):
        return Spectral(self.U, self.s ** exponent, self.device)


def dot(X, Y=None, method='auto', rcond=0, mode='truncate', device='cuda'):
    """Factored matrix ``X @ Y`` (two factors) or ``X @ X.T`` through a
    spectral decomposition (Y omitted)."""
    if Y is None:
        if method == 'direct':
            X = as_tensor(X, device)
            return Factored([(X, X.T)], device)
        return Spectral.from_root(X, rcond=rcond, mode=mode, device=device)
    if method == 'spectral':
        raise RuntimeError(
            'The spectral form requires a symmetric product (Y=None).')
    return Factored([(X, Y)], device)


def pinvh(A, d, k='auto', rcond=1e-10, mode='truncate', n_iter=32,
          seed=0):
    """Pseudoinverse of ``A + diag(d)`` (A factored PSD) as a
    :class:`Spectral` on A's device, keeping the top-k eigenspace.

    Matrix-free randomized subspace iteration: every step is a tall matmul
    through A's factors plus a diagonal scaling, then a QR, on the device;
    the start block is drawn on the host from ``default_rng(seed)``, as the
    JAX module draws it.
    """
    n = len(d)
    if k == 'auto':
        k = min(n, sum(L.shape[1] for L, _ in A.terms)
                + int(np.count_nonzero(d)))
    assert isinstance(k, (int, np.integer)) and 0 < k <= n
    d = as_tensor(d, A.device)

    def apply(V):
        return sum(L @ (R @ V) for L, R in A.terms) + d[:, None] * V

    rng = np.random.default_rng(seed)
    V = as_tensor(np.linalg.qr(rng.standard_normal((n, k)))[0], A.device)
    for _ in range(n_iter):
        V = torch.linalg.qr(apply(V))[0]
    # Rayleigh-Ritz on the converged subspace
    T = V.T @ apply(V)
    w, S = torch.linalg.eigh((T + T.T) / 2)
    w, Q = w.flip(0), (V @ S).flip(1)

    floor = w[0] * rcond
    above = w > floor
    if mode == 'truncate':
        w, Q = w[above], Q[:, above]
    elif mode == 'clamp':
        w = torch.where(above, w, floor)
    else:
        raise RuntimeError(f"Unknown pseudoinverse mode '{mode}'.")
    return Spectral(Q, w ** -0.5, A.device)


# compatibility aliases for the reference's class names
def LATR(lhs, rhs, device='cuda'):
    return Factored([(lhs, rhs)], device)


def LLT(X, rcond=0, mode='truncate', device='cuda'):
    if isinstance(X, tuple):
        return Spectral(*X, device=device)
    return Spectral.from_root(X, rcond=rcond, mode=mode, device=device)
