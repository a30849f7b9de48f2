"""Minimal Atoms duck-type so molecular pipelines work without ASE; a copy
of ``graphdot_tpu/dataset/_atoms.py``.

Implements exactly the interface consumed by
``graphdot_tpu_torch.graph._from_ase`` (positions / atomic numbers / cell /
pbc); real ``ase.Atoms`` objects are used instead whenever ASE is
installed. What differs from the JAX module: :func:`make_atoms` looks ASE
up once a process, where the JAX module tries ``from ase import Atoms``
at every call: without ASE each failed import searches the module path
again, 7165 times in ``QM7(ase=True)``.
"""
import functools

import numpy as np

_SYMBOLS = {
    1: 'H', 2: 'He', 3: 'Li', 4: 'Be', 5: 'B', 6: 'C', 7: 'N', 8: 'O',
    9: 'F', 10: 'Ne', 11: 'Na', 12: 'Mg', 13: 'Al', 14: 'Si', 15: 'P',
    16: 'S', 17: 'Cl', 18: 'Ar', 19: 'K', 20: 'Ca', 35: 'Br', 53: 'I',
}


class SimpleAtoms:
    """A molecule as atomic numbers + 3D positions (no PBC)."""

    def __init__(self, numbers, positions, charges=None):
        self.numbers = np.asarray(numbers, dtype=int)
        self.positions = np.asarray(positions, dtype=float)
        self.charges = (
            np.asarray(charges, dtype=float) if charges is not None
            else np.zeros(len(self.numbers))
        )
        assert self.positions.shape == (len(self.numbers), 3)
        self.pbc = np.zeros(3, dtype=bool)
        self.cell = np.zeros((3, 3))

    def __len__(self):
        return len(self.numbers)

    def get_atomic_numbers(self):
        return self.numbers

    def get_positions(self):
        return self.positions

    def get_initial_charges(self):
        return self.charges

    def get_chemical_formula(self):
        counts = {}
        for z in self.numbers:
            s = _SYMBOLS.get(int(z), f'Z{int(z)}')
            counts[s] = counts.get(s, 0) + 1
        return ''.join(
            f'{s}{n if n > 1 else ""}' for s, n in sorted(counts.items())
        )


@functools.lru_cache(maxsize=None)
def _ase_atoms():
    """``ase.Atoms``, or None where ASE is not installed."""
    try:
        from ase import Atoms
    except ImportError:
        return None
    return Atoms


def make_atoms(numbers, positions, charges=None):
    """ase.Atoms when available, SimpleAtoms otherwise."""
    Atoms = _ase_atoms()
    if Atoms is None:
        return SimpleAtoms(numbers, positions, charges)
    a = Atoms(numbers=numbers, positions=positions)
    if charges is not None:
        a.set_initial_charges(charges)
    return a
