"""Molecule data for the port; counterpart of ``graphdot_tpu/dataset/``.

The loaders ``get``, ``QM7``, ``QM9``, ``METLIN_SMRT`` and ``AMES`` are
copies of the JAX package's, which return ``pandas`` frames; they import
``pandas`` (and ``requests``, only to fetch a file that is not there yet)
when they run, so importing this package imports neither. Beside them
are the atoms duck-type (:mod:`._atoms`) and ``load_qm7``
(:mod:`.qm7_fixture`): a real ``qm7.mat`` when one is present, else the
offline QM7 surrogate.
"""
from ._get import get
from .ames import AMES
from .metlin_smrt import METLIN_SMRT
from .qm7 import QM7
from .qm9 import QM9

__all__ = ['get', 'QM7', 'QM9', 'METLIN_SMRT', 'AMES']
