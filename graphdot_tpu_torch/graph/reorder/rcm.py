"""Reverse Cuthill-McKee reordering (reference:
``graphdot/graph/reorder/rcm.py:6``); a copy of
``graphdot_tpu/graph/reorder/rcm.py``."""
import scipy.sparse


def rcm(g):
    """Compute the reverse Cuthill-McKee permutation of a graph. Does NOT
    modify the graph; returns a permutation vector for ``Graph.permute``.
    """
    return scipy.sparse.csgraph.reverse_cuthill_mckee(
        g.adjacency_matrix.tocsr(), symmetric_mode=True
    )
