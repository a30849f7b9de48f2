"""Execution policy for host-facing dense linear algebra; counterpart of
``graphdot_tpu/linalg/_exec.py``.

The sklearn-style model API hands numpy float64 arrays to its
decompositions, and its closed-form likelihood and LOOCV identities
assume double precision. Here every such function runs in float64 on an
explicit torch device: ``torch.linalg`` (cuSOLVER and cuBLAS on the card,
LAPACK on the CPU). The H100 computes float64 natively, so there is no
detour to the host as the JAX module takes when its default device cannot
run float64 (its ``_f64_device``).
"""
import numpy as np
import torch

from ..kernel.marginalized._backend import resolve_device
from ..util.trace import span


def _to_numpy(out):
    if isinstance(out, torch.Tensor):
        with span('host_sync'):
            return out.detach().cpu().numpy()
    if isinstance(out, (tuple, list)):
        return type(out)(_to_numpy(o) for o in out)
    return out


def as_tensor(a, device):
    """An array or tensor as a float64 tensor on ``device`` (resolved: a
    CUDA device without a card raises)."""
    device = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def run(fn, *arrays, device='cuda'):
    """Run a tensor function on ``device`` with every array argument as a
    float64 tensor; returns its outputs (a tensor or a tuple of them) as
    numpy arrays. A CUDA device without a card raises."""
    return _to_numpy(fn(*(as_tensor(a, device) for a in arrays)))


def _cho_apply(L, B):
    return torch.cholesky_solve(B if B.dim() > 1 else B[:, None], L) \
        .reshape(B.shape)


def _svd(X):
    return torch.linalg.svd(X, full_matrices=False)


def _cholesky(A):
    """Lower Cholesky factor; where A is not positive definite, NaN on and
    below the diagonal and 0 above (as ``jnp.linalg.cholesky`` returns
    it)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan).tril()


def _eigh(H):
    """The eigendecomposition of the symmetric part of H, as
    ``jnp.linalg.eigh`` takes it (``torch.linalg.eigh`` reads one
    triangle)."""
    return torch.linalg.eigh(0.5 * (H + H.T))


def eigh(H, device='cuda'):
    """Ascending eigendecomposition of a symmetric matrix (numpy out)."""
    return run(_eigh, H, device=device)


def cholesky(A, device='cuda'):
    """Lower Cholesky factor; NaN-filled where A is not PD (numpy out)."""
    return run(_cholesky, A, device=device)


def cho_apply(L, B, device='cuda'):
    """Solve ``A x = B`` given the lower Cholesky factor of A."""
    return run(_cho_apply, L, B, device=device)


def svd(X, device='cuda'):
    """Thin SVD (U, s, Vt) as numpy arrays."""
    return run(_svd, X, device=device)
