"""QM9 dataset loader; a copy of ``graphdot_tpu/dataset/qm9.py`` (the role
of the reference's ``graphdot/dataset/qm9.py:12``).

What differs from the JAX module: ``pandas`` is imported when the loader
runs, and ``ase=True`` builds each molecule through
:func:`._atoms.make_atoms` (``ase.Atoms`` when ASE is installed, else
:class:`._atoms.SimpleAtoms`) from atomic numbers that a symbol table of
this module gives, where the JAX module requires ASE
(``ase.Atoms(symbols=...)``). Either way an atom carries its number, its
position and its Mulliken charge.
"""
import io
import tarfile

import numpy as np

from ._atoms import make_atoms
from ._get import get

_SCALARS = ['A', 'B', 'C', 'mu', 'alpha', 'e_HOMO', 'e_LUMO', 'e_gap',
            'R2', 'zpve', 'U0', 'U', 'H', 'G', 'Cv']

#: atomic number of each element symbol, H to Kr, and I
_NUMBERS = {s: z for z, s in enumerate(
    'X H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe '
    'Co Ni Cu Zn Ga Ge As Se Br Kr'.split()) if z}
_NUMBERS['I'] = 53


def _parse_record(text):
    """One extended-XYZ record of the GDB-9 archive -> property dict.

    Layout per Ramakrishnan et al. 2014: line 0 atom count; line 1 the
    'gdb <id> <15 scalar properties>' tag line; then one
    'symbol x y z mulliken' line per atom; harmonic frequencies; SMILES
    (GDB + optimized); InChI (GDB + optimized).
    """
    lines = text.replace('*^', 'E').split('\n')
    count = int(lines[0])
    tag = lines[1][4:].strip().split('\t')
    record = {'id': int(tag[0])}
    record.update(zip(_SCALARS, map(float, tag[1:])))

    table = [row.split('\t') for row in lines[2:count + 2]]
    record['symbols'] = tuple(row[0] for row in table)
    record['xyz'] = [
        [float(v) for v in row[1:4]] for row in table
    ]
    record['charges_mulliken'] = tuple(row[4] for row in table)
    record['freq'] = [
        float(v) for v in lines[count + 2].strip().split('\t')
    ]
    record['smiles_gdb'], record['smiles_opt'] = \
        lines[count + 3].strip().split('\t')
    record['inchi_gdb'], record['inchi_opt'] = \
        lines[count + 4].strip().split('\t')
    return record


def QM9(download_url='https://ndownloader.figshare.com/files/3195389',
        local_filename='dsgdb9nsd.xyz.tar.bz2', overwrite=False,
        ase=False):
    """Quantum chemistry structures and properties of ~134k molecules
    (Ramakrishnan et al., Scientific Data 2014).

    Returns
    -------
    pandas.DataFrame with a column for each field of :func:`_parse_record`
    (and an 'atoms' column with ``ase``)."""
    import pandas as pd
    try:
        archive = get(download_url, local_filename, overwrite=overwrite)
    except Exception as e:
        raise RuntimeError(
            f'Acquiring {local_filename} failed due to error: {e}.')

    records = []
    with tarfile.open(archive, 'r:bz2') as tf:
        for member in tf:
            records.append(_parse_record(
                io.TextIOWrapper(tf.extractfile(member)).read()))
    qm9 = pd.DataFrame.from_records(records)

    if ase is True:
        qm9['atoms'] = [
            make_atoms([_NUMBERS[s] for s in row.symbols], row.xyz,
                       np.asarray(row.charges_mulliken, dtype=float))
            for row in qm9.itertuples()
        ]
    return qm9
