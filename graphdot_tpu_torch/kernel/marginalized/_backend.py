"""Backend selection; counterpart of
``graphdot_tpu/kernel/marginalized/_backend.py``.

Four ways to solve the product-graph systems:

- ``'cuda'`` (what ``'auto'`` picks on a CUDA device): the edge-factored
  operands go to the hand-written PCG kernels: ``ops/pcg.py::pcg_resident``
  (one CTA per pair, all CG state in shared memory), ``pcg_cluster`` for
  pairs beyond a block that fit a cluster of at most 16 CTAs,
  ``pcg_stream`` beyond that, and ``pcg_packed`` for the
  gradient's tangent systems (one CTA per pair's group of them). Pairs
  beyond a block whose product space exceeds ``_solver.KRON_MIN_N`` and
  whose edge kernel calibrates take the kron route instead
  (``_solver.solve_route``).
- ``'kron'``: every pair by the sum-of-Kronecker solver (``_kron.py``):
  the edge kernel of one or two scalar edge features factorized on a
  Chebyshev grid, two batched products a matvec in node space, no
  edge-coupling matrix; on the card and on the CPU alike.
- ``'edge'`` (what ``'auto'`` picks on the CPU): the same edge-factored
  matvec in plain torch (gathers and index-adds over the edge lists) inside
  a batched PCG.
- ``'dense'``: the dense product-graph coupling tensor, one contraction per
  CG step, O(n1^2 n2^2); for validation and tiny graphs.

A mode that fails raises; no mode stands in for another.
"""
import torch


class Backend:
    """Computing engine that solves the marginalized graph kernel's
    generalized Laplacian equation."""

    MODES = ('cuda', 'edge', 'dense', 'kron')

    def __init__(self, mode='edge'):
        if mode not in self.MODES:
            raise ValueError(f'Unknown backend mode {mode!r}')
        self.mode = mode


def backend_factory(backend, device):
    """Resolve ``backend`` ('auto', a mode name or a Backend) for tensors
    on ``device`` (a torch.device)."""
    if isinstance(backend, Backend):
        return backend
    if backend == 'auto':
        return Backend('cuda' if device.type == 'cuda' else 'edge')
    if backend in Backend.MODES:
        return Backend(backend)
    raise ValueError(f'Unknown backend {backend!r}')


def resolve_device(device):
    """A torch.device for ``device``; raises for a CUDA device when there
    is no usable card, instead of running elsewhere."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device={str(device)!r} was asked for, but torch finds no CUDA '
            'device')
    return device
