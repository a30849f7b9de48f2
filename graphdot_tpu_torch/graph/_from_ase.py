"""Molecular graph construction from 3D atomic coordinates; a copy of
``graphdot_tpu/graph/_from_ase.py`` (numpy plus scipy's ``cKDTree``).

Only the documented ``ase.Atoms`` duck-type interface is used (positions /
atomic numbers / cell / pbc), so ASE itself is optional; see
``graphdot_tpu_torch.dataset._atoms.SimpleAtoms``.
"""
import itertools
import uuid

import numpy as np
from scipy.spatial import cKDTree

from .adjacency.atomic import AtomicAdjacency
from .frame import DataFrame


def _periodic_images(atoms, use_pbc):
    """Translation vectors of all periodic images within one cell shift,
    and the map from image-atom index back to the unit-cell atom."""
    pbc = np.logical_and(np.asarray(atoms.pbc), use_pbc)
    cell = np.asarray(atoms.cell)
    shift_ranges = [(-1, 0, 1) if p else (0,) for p in pbc]
    shifts = [
        (cell.T * s).sum(axis=1)
        for s in itertools.product(*shift_ranges)
    ]
    n = len(atoms)
    x = np.asarray(atoms.get_positions())
    tiled = np.vstack([x + t for t in shifts])
    owner = np.tile(np.arange(n), len(shifts))
    return x, tiled, owner


def _from_ase(cls, atoms, adjacency='default', use_charge=False,
              use_pbc=True):
    """Build a molecular graph: atoms become nodes; pairs of atoms within
    the adjacency rule's cutoff become edges with weight w = shape(r/σ)
    and a 'length' feature."""
    if adjacency == 'default':
        adjacency = AtomicAdjacency()

    numbers = np.asarray(atoms.get_atomic_numbers())
    nodes = DataFrame({'!i': range(len(atoms))})
    nodes['element'] = numbers.astype(np.int8)
    if use_charge:
        nodes['charge'] = np.asarray(
            atoms.get_initial_charges()
        ).astype(np.float32)

    x, tiled, owner = _periodic_images(atoms, use_pbc)
    cutoff = adjacency.cutoff(numbers)
    neighbors = cKDTree(x).sparse_distance_matrix(
        cKDTree(tiled), cutoff
    )

    # keep, for each unordered atom pair, the closest image with a
    # positive adjacency weight
    best = {}
    for (i, jj), r in neighbors.items():
        j = int(owner[jj])
        if j <= i:
            continue
        key = (int(i), j)
        if key in best and best[key][0] <= r:
            continue
        w = adjacency(numbers[i], numbers[j], r)
        if w > 0:
            best[key] = (r, w)
    if not best:
        raise RuntimeError('Molecule has no bonds within the cutoff.')

    ij = np.array(sorted(best), dtype=np.uint32)
    rw = np.array([best[tuple(k)] for k in ij], dtype=np.float32)
    edges = DataFrame({
        '!i': ij[:, 0],
        '!j': ij[:, 1],
        '!w': rw[:, 1],
        'length': rw[:, 0],
    })

    try:
        formula = atoms.get_chemical_formula()
    except Exception:
        formula = ''
    return cls(
        nodes, edges,
        title=f'Molecule {formula} {uuid.uuid4().hex}'
    )
