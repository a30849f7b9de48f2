"""Adjacency rules of molecular graphs from atoms; a copy of
``graphdot_tpu/graph/adjacency/``."""
from .atomic import AtomicAdjacency
from .euclidean import CompactBell, Gaussian, Tent

__all__ = ['AtomicAdjacency', 'Gaussian', 'Tent', 'CompactBell']
