"""Node reordering strategies (reference: ``graphdot/graph/reorder/``); a
copy of ``graphdot_tpu/graph/reorder`` (scipy only).

Reordering reduces the number of non-empty tiles in a blocked adjacency
layout, the reference's octile-count minimization for its CUDA kernel. The
port's kernels gather over edge lists and need no reordering; these
permutations are for callers that lay graphs out in tiles.
"""
from .rcm import rcm
from .pbr import pbr

__all__ = ['rcm', 'pbr']
