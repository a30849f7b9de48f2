"""Adaptor for pymatgen Molecule objects; the counterpart of
``graphdot_tpu/graph/_from_pymatgen.py`` (the reference's
``graphdot/graph/_from_pymatgen.py``).

What differs from the JAX module: ``from_ase`` gets ``use_pbc`` and
``adjacency`` by keyword. The JAX module passes them by position,
``cls.from_ase(atoms, use_pbc, adjacency)``, against the signature
``from_ase(atoms, adjacency='default', use_charge=False, use_pbc=True)``,
so there ``use_pbc`` lands in ``adjacency`` and ``adjacency`` in
``use_charge``.
"""


def _from_pymatgen(cls, molecule, use_pbc=True, adjacency='default'):
    """Convert a pymatgen molecule to a molecular graph via the ASE path."""
    import pymatgen.io.ase
    atoms = pymatgen.io.ase.AseAtomsAdaptor.get_atoms(molecule)
    return cls.from_ase(atoms, adjacency=adjacency, use_pbc=use_pbc)
