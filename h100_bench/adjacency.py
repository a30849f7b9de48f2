"""Edges of a molecular graph from its atoms: a frozen copy of the port's
default adjacency rule (``graph/_from_ase.py`` with
``graph/adjacency/atomic.py``'s ``AtomicAdjacency()``: the shape
``tent1`` on van der Waals radii).

Two atoms i < j are joined when their distance r is below the cutoff
``3 sqrt(l_i l_j)`` of the rule, with weight ``w = 1 - r / (3 sqrt(l_i
l_j))`` and the feature ``length = r``, both stored as float32, as
``Graph.from_ase(atoms, use_pbc=False)`` stores them.

Where it differs from the original: it takes a batch of molecules padded to
one atom count and works on their dense distance matrices (no ``cKDTree``,
no periodic images: the molecules are not periodic), and it holds only the
radii of the elements that the QM7 recipe makes (H, C, N, O, S; the
original's table of Bondi radii has the same values, ``_ptable.py``).
"""
import numpy as np
import torch

#: van der Waals radii in Angstrom (Bondi 1964), as ``_ptable._VDW``
VDW_RADIUS = {1: 1.20, 6: 1.70, 7: 1.55, 8: 1.52, 16: 1.80}
#: the tent's support, in units of the pair's length scale
SUPPORT = 3.0


def radii(numbers):
    """[..] float64 radii of atomic numbers (a tensor; 0 where a number is
    0, the padding)."""
    table = torch.zeros(max(VDW_RADIUS) + 1, dtype=torch.float64,
                        device=numbers.device)
    for z, r in VDW_RADIUS.items():
        table[z] = r
    return table[numbers.long()]


def molecule_edges(numbers, positions):
    """The edges of a batch of molecules by the rule.

    numbers: [B, A] int tensor of atomic numbers, 0 beyond a molecule's
        atoms; positions: [B, A, 3] float64 tensor.

    Returns a list of B tuples (src, dst, w, length) of numpy arrays, the
    edges i < j in (i, j) order, src and dst uint32, w and length float32.
    """
    real = numbers > 0
    diff = positions[:, :, None, :] - positions[:, None, :, :]
    r = torch.sqrt((diff * diff).sum(-1))
    lr = radii(numbers)
    sigma = torch.sqrt(lr[:, :, None] * lr[:, None, :])
    A = numbers.shape[1]
    upper = torch.triu(torch.ones(A, A, dtype=torch.bool,
                                  device=numbers.device), diagonal=1)
    pair = real[:, :, None] & real[:, None, :] & upper
    w = 1.0 - r / (SUPPORT * torch.where(pair, sigma, 1.0))
    edge = pair & (w > 0)
    b, i, j = (t.cpu().numpy() for t in torch.nonzero(edge, as_tuple=True))
    w = w[edge].float().cpu().numpy()
    length = r[edge].float().cpu().numpy()
    bounds = np.searchsorted(b, np.arange(numbers.shape[0] + 1))
    return [(i[s:e].astype(np.uint32), j[s:e].astype(np.uint32), w[s:e],
             length[s:e]) for s, e in zip(bounds[:-1], bounds[1:])]
