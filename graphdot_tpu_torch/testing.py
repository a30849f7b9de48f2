"""Synthetic graph sets, reused from :mod:`graphdot_tpu.testing` (which
loads no JAX), and the categorical-edge protein set of ``bench_protein.py``.
"""
import numpy as np

from graphdot_tpu.graph import Graph
from graphdot_tpu.testing import random_molecule_set, random_protein_set

__all__ = ['random_molecule_set', 'random_protein_set', 'protein_niche_set']


def protein_niche_set(seed, n, n_residues_range):
    """``n`` random contact-map proteins with a categorical contact type
    on every edge, ``ctype = min(|i - j| // 6, 2)`` for residues i and j,
    beside the edge ``length``: the graphs of the categorical-edge
    ("niche") class of ``bench_protein.py``, built by the same recipe."""
    graphs = []
    for g in random_protein_set(seed, n, n_residues_range=n_residues_range):
        e = g.edges
        ctype = np.minimum(
            np.abs(np.asarray(e['!i']) - np.asarray(e['!j'])) // 6, 2
        ).astype(np.float32)
        graphs.append(Graph(
            nodes=g.nodes,
            edges={'!i': e['!i'], '!j': e['!j'], '!w': e['!w'],
                   'length': e['length'], 'ctype': ctype},
            title=g.title))
    return Graph.unify_datatype(graphs)
