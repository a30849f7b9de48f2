"""Offline QM7 access: the real archive when present, otherwise the
committed surrogate fixture; a copy of
``graphdot_tpu/dataset/qm7_fixture.py``.

``load_qm7`` reads a real ``qm7.mat`` through :func:`.qm7.QM7` when one
exists at ``real_path``, and otherwise ``tests/fixtures/qm7_surrogate.npz``:
100 deterministic, valence-correct molecules (<= 7 heavy atoms of C/N/O/S +
H) with force-field-relaxed geometries and bond-enthalpy atomization
energies (``scripts/make_qm7_fixture.py``).
"""
import os

import numpy as np

from ._atoms import make_atoms

_FIXTURE = os.path.join(
    os.path.dirname(__file__), '..', '..', 'tests', 'fixtures',
    'qm7_surrogate.npz')


def load_qm7(n=None, real_path='qm7.mat', fixture_path=None):
    """(molecules, energies, source): the first ``n`` (default: all)
    molecules as Atoms-like objects, their atomization energies (kcal/mol)
    and the source, ``'qm7.mat'`` or ``'surrogate'``."""
    if os.path.exists(real_path):
        from .qm7 import QM7
        table = QM7(local_filename=real_path, ase=True)
        if n is not None:
            table = table.iloc[:n]
        return (list(table.atoms), table.atomization_energy.to_numpy(),
                'qm7.mat')

    path = fixture_path or _FIXTURE
    blob = np.load(path)
    offsets = blob['offsets']
    count = len(offsets) - 1 if n is None else min(n, len(offsets) - 1)
    molecules = [
        make_atoms(
            blob['numbers'][offsets[i]:offsets[i + 1]],
            blob['positions'][offsets[i]:offsets[i + 1]])
        for i in range(count)
    ]
    return molecules, blob['energy'][:count].astype(float), 'surrogate'
