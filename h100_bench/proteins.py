"""Contact-map proteins from a seed: a frozen copy of
``graphdot_tpu_torch/testing.py``'s ``random_protein_graph`` and, where
asked for, ``protein_niche_set``'s categorical contact class (the recipe
of ``bench_protein.py``'s categorical-edge set).

A protein is a globular self-avoiding walk of CA atoms 3.8 A apart, 20
residue labels (``element``), and an edge between residues i < j within 8
A, with its ``length``, the weight ``exp(-(length / 8)^2 / 2)`` and, with
``contact_class``, the class ``ctype = min(|i - j| // 6, 2)``, all
float32. No cell of the benchmark uses it yet; the reference's edge path
and its tests do.

Where it differs from the original: the residue counts of a set are not
drawn one by one. A set of n proteins over [lo, hi) holds the counts
``lo + k (hi - lo) // n`` for k = 0..n-1, in an order drawn from the seed,
so that every seed makes the same amount of work. Each walk then draws from
``numpy.random.default_rng(seed)`` as the original does (``seed`` an int
or a list of them).
"""
import numpy as np

CUTOFF = 8.0
STEP = 3.8
CLEARANCE = 4.5
TRIES = 40


def protein_graph(rng, n, contact_class=True):
    """One contact map of n residues, as the original's
    ``random_protein_graph``, with the contact class where asked for."""
    from scipy.spatial import cKDTree
    radius = 3.1 * n ** (1.0 / 3.0)
    pos = np.zeros((n, 3))
    for i in range(1, n):
        best, best_clearance = None, -np.inf
        for _ in range(TRIES):
            step = rng.normal(size=3)
            cand = pos[i - 1] + STEP * step / np.linalg.norm(step)
            if np.linalg.norm(cand) > radius:
                continue
            clearance = np.min(
                np.linalg.norm(pos[:i - 1] - cand, axis=1)
            ) if i > 1 else np.inf
            if clearance > CLEARANCE:
                best = cand
                break
            if clearance > best_clearance:
                best, best_clearance = cand, clearance
        pos[i] = best
    element = rng.integers(0, 20, size=n).astype(np.int8)
    pairs = sorted(cKDTree(pos).query_pairs(CUTOFF))
    src = np.asarray([i for i, _ in pairs], dtype=np.uint32)
    dst = np.asarray([j for _, j in pairs], dtype=np.uint32)
    length = np.linalg.norm(pos[src] - pos[dst], axis=1).astype(np.float32)
    w = np.exp(-0.5 * (length / CUTOFF) ** 2).astype(np.float32)
    edge = {'length': length}
    if contact_class:
        edge['ctype'] = np.minimum(
            np.abs(src.astype(np.int64) - dst.astype(np.int64)) // 6,
            2).astype(np.float32)
    return {'n': n, 'node': {'element': element}, 'src': src, 'dst': dst,
            'w': w, 'edge': edge}


def residue_counts(n, lo, hi):
    """The residue counts of a set of n proteins over [lo, hi), before the
    seed's order."""
    return np.array([lo + k * (hi - lo) // n for k in range(n)])


def make_proteins(seed, n, lo, hi, contact_class=True):
    """n contact maps from ``seed``, as :mod:`h100_bench.reference` holds
    graphs."""
    rng = np.random.default_rng(seed)
    counts = rng.permutation(residue_counts(n, lo, hi))
    return [protein_graph(rng, int(c), contact_class) for c in counts]
