"""QM7 dataset loader; a copy of ``graphdot_tpu/dataset/qm7.py`` (the
reference's ``graphdot/dataset/qm7.py:10``).

What differs from the JAX module: ``pandas`` is imported when the loader
runs, not when the module is imported.
"""
import numpy as np
import scipy.io

from ._atoms import make_atoms
from ._get import get


def QM7(download_url='http://quantum-machine.org/data/qm7.mat',
        local_filename='qm7.mat', overwrite=False, ase=False):
    """A 7165-molecule subset of GDB-13: up to 23 atoms / 7 heavy atoms,
    with PBE0 atomization energies.

    Parameters
    ----------
    ase: bool
        If True, add an 'atoms' column of Atoms objects (real ase.Atoms
        when ASE is installed, a compatible lightweight shim otherwise).

    Returns
    -------
    pandas.DataFrame with columns coulomb_matrix, atomization_energy,
    atomic_charge, xyz, split (and optionally atoms).
    """
    import pandas as pd
    try:
        mat = scipy.io.loadmat(
            get(download_url, local_filename, overwrite=overwrite)
        )
    except Exception as e:
        raise RuntimeError(
            f'Loading {local_filename} failed due to error: {e}.'
        )

    def column_of_arrays(stack):
        return pd.Series(list(stack), dtype=object)

    n = len(mat['T'].ravel())
    split = np.zeros(n, dtype=int)
    for fold, members in enumerate(mat['P']):
        split[members] = fold

    qm7 = pd.DataFrame({
        'coulomb_matrix': column_of_arrays(mat['X']),
        'atomization_energy': mat['T'].ravel().astype(float),
        'atomic_charge': column_of_arrays(mat['Z']),
        'xyz': column_of_arrays(mat['R']),
        'split': split,
    })

    if ase is True:
        def to_atoms(row):
            live = row.atomic_charge != 0
            return make_atoms(row.atomic_charge[live], row.xyz[live])
        qm7['atoms'] = qm7.apply(to_atoms, axis=1)

    return qm7
