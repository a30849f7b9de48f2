"""Synthetic graph sets for tests, benchmarks and dry runs: random
molecules and contact-map proteins (the same generators, seeds and
numbers as :mod:`graphdot_tpu.testing`), and the categorical-edge
protein set of ``bench_protein.py``.
"""
import numpy as np

from .graph import Graph
from .graph.frame import DataFrame

__all__ = ['random_molecule_graph', 'random_molecule_set',
           'random_protein_graph', 'random_protein_set',
           'protein_niche_set']


def random_molecule_graph(rng, n_atoms, elements=(1, 6, 7, 8, 16)):
    """A random molecule-like graph: a connected chain plus extra short
    bonds, with 'element' node features and 'length' + '!w' edge features —
    the same feature signature as ``Graph.from_ase`` output."""
    n = int(n_atoms)
    element = rng.choice(elements, size=n).astype(np.int8)
    src = [i for i in range(n - 1)]
    dst = [i + 1 for i in range(n - 1)]
    extra = max(0, n // 3)
    for _ in range(extra):
        i, j = rng.integers(0, n, size=2)
        if i != j and abs(int(i) - int(j)) > 1:
            src.append(min(i, j))
            dst.append(max(i, j))
    # dedup
    seen = {}
    for i, j in zip(src, dst):
        seen[(int(i), int(j))] = True
    src, dst = zip(*seen.keys())
    length = rng.uniform(1.0, 1.8, size=len(src)).astype(np.float32)
    w = np.exp(-0.5 * (length - 1.4) ** 2).astype(np.float32)

    nodes = DataFrame({'!i': np.arange(n), 'element': element})
    edges = DataFrame({
        '!i': np.asarray(src, dtype=np.uint32),
        '!j': np.asarray(dst, dtype=np.uint32),
        '!w': w,
        'length': length,
    })
    return Graph(nodes, edges, title=f'random-{n}')


def random_molecule_set(seed, n_graphs, n_atoms_range=(9, 24)):
    """A list of random molecule graphs with unified dtypes."""
    rng = np.random.default_rng(seed)
    graphs = [
        random_molecule_graph(
            rng, rng.integers(n_atoms_range[0], n_atoms_range[1])
        )
        for _ in range(n_graphs)
    ]
    return Graph.unify_datatype(graphs)


def random_protein_graph(rng, n_residues, cutoff=8.0):
    """A random protein-like contact-map graph: a self-avoiding 3-D
    backbone walk of ``n_residues`` residues (~3.8 A consecutive-CA
    spacing), 20-letter 'element' node labels, and edges between residues
    within ``cutoff`` A carrying a 'length' feature and a Gaussian
    distance weight — the workload shape of the reference's protein
    benchmark (``example/perfbench/protein-time-to-solution.py``), where
    n1*n2 reaches 1e4-1e6 on the product space."""
    n = int(n_residues)
    # globular self-avoiding walk: steps are rejected when they land
    # within 4.5 A of an earlier residue or outside the target globule
    # radius (R ~ n^(1/3) at protein packing density), which reproduces
    # the ~6-13 contacts per residue of real 8 A contact maps
    radius = 3.1 * n ** (1.0 / 3.0)
    pos = np.zeros((n, 3))
    for i in range(1, n):
        best, best_clearance = None, -np.inf
        for _ in range(40):
            step = rng.normal(size=3)
            cand = pos[i - 1] + 3.8 * step / np.linalg.norm(step)
            if np.linalg.norm(cand) > radius:
                continue
            clearance = np.min(
                np.linalg.norm(pos[:i - 1] - cand, axis=1)
            ) if i > 1 else np.inf
            if clearance > 4.5:
                best = cand
                break
            if clearance > best_clearance:
                best, best_clearance = cand, clearance
        pos[i] = best
    element = rng.integers(0, 20, size=n).astype(np.int8)

    from scipy.spatial import cKDTree
    tree = cKDTree(pos)
    pairs = sorted(tree.query_pairs(cutoff))
    src = np.asarray([i for i, _ in pairs], dtype=np.uint32)
    dst = np.asarray([j for _, j in pairs], dtype=np.uint32)
    length = np.linalg.norm(
        pos[src] - pos[dst], axis=1).astype(np.float32)
    w = np.exp(-0.5 * (length / cutoff) ** 2).astype(np.float32)

    nodes = DataFrame({'!i': np.arange(n), 'element': element})
    edges = DataFrame({'!i': src, '!j': dst, '!w': w, 'length': length})
    return Graph(nodes, edges, title=f'protein-{n}')


def random_protein_set(seed, n_graphs, n_residues_range=(150, 300)):
    """A list of random protein-like graphs with unified dtypes."""
    rng = np.random.default_rng(seed)
    graphs = [
        random_protein_graph(
            rng, rng.integers(n_residues_range[0], n_residues_range[1])
        )
        for _ in range(n_graphs)
    ]
    return Graph.unify_datatype(graphs)


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
