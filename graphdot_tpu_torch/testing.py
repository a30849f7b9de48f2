"""Synthetic graph sets, reused from :mod:`graphdot_tpu.testing` (which
loads no JAX)."""
from graphdot_tpu.testing import random_molecule_set

__all__ = ['random_molecule_set']
