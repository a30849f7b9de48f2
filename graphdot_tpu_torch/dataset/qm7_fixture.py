"""Offline QM7 surrogate; counterpart of
``graphdot_tpu/dataset/qm7_fixture.py``.

``load_qm7`` reads ``tests/fixtures/qm7_surrogate.npz``: 100
deterministic, valence-correct molecules (<= 7 heavy atoms of C/N/O/S + H)
with force-field-relaxed geometries and bond-enthalpy atomization energies
(``scripts/make_qm7_fixture.py``). What differs from the JAX module: the
surrogate branch only. The JAX module switches to a real ``qm7.mat`` when
one is present, through its ``dataset/qm7.py`` loader, which the port does
not carry.
"""
import os

import numpy as np

from ._atoms import make_atoms

_FIXTURE = os.path.join(
    os.path.dirname(__file__), '..', '..', 'tests', 'fixtures',
    'qm7_surrogate.npz')


def load_qm7(n=None, fixture_path=None):
    """(molecules, energies, source): the first ``n`` (default: all)
    molecules of the surrogate as Atoms-like objects, their atomization
    energies (kcal/mol) and the source, always ``'surrogate'``."""
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
