"""Molecule data for the port; counterpart of ``graphdot_tpu/dataset/``.

The port carries the atoms duck-type (:mod:`._atoms`) and the offline QM7
surrogate (:mod:`.qm7_fixture`). The downloading loaders of the JAX package
(``_get``, ``QM7``, ``QM9``, ``METLIN_SMRT``, ``AMES``) are not ported.
"""
