"""The benchmark's generators: the same seed gives the same inputs, another
seed other inputs of the same sizes, and the frozen adjacency rule gives the
edges that the program's ``Graph.from_ase`` gives."""
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from h100_bench.molecules import heavy_counts, make_molecules  # noqa: E402
from h100_bench.proteins import make_proteins  # noqa: E402

HIST = json.loads((ROOT / 'h100_bench' / 'configs' / 'qm7-tang2019.json'
                   ).read_text())['dataset']['heavy_atoms']


def same(a, b):
    return a['n'] == b['n'] and all(
        np.array_equal(a[k], b[k]) for k in ('src', 'dst', 'w')) and all(
        np.array_equal(a['node'][f], b['node'][f]) for f in a['node']) and all(
        np.array_equal(a['edge'][f], b['edge'][f]) for f in a['edge'])


def test_molecules_repeat_by_seed():
    g1, e1 = make_molecules(2**31 + 11, 12, 'cpu', HIST)
    g2, e2 = make_molecules(2**31 + 11, 12, 'cpu', HIST)
    g3, e3 = make_molecules(2**31 + 12, 12, 'cpu', HIST)
    assert all(same(a, b) for a, b in zip(g1, g2))
    assert np.array_equal(e1, e2)
    assert not all(same(a, b) for a, b in zip(g1, g3))
    heavy = sorted(int((g['node']['element'] > 1).sum()) for g in g1)
    assert heavy == sorted(heavy_counts(12, HIST))
    assert sorted(g['n'] for g in g1) == sorted(g['n'] for g in g3)
    assert max(g['n'] for g in g1) <= 23
    assert all(len(g['src']) > 0 for g in g1)


def test_proteins_repeat_by_seed():
    p1 = make_proteins(5, 3, 20, 35)
    p2 = make_proteins(5, 3, 20, 35)
    p3 = make_proteins(6, 3, 20, 35)
    assert all(same(a, b) for a, b in zip(p1, p2))
    assert sorted(g['n'] for g in p1) == sorted(g['n'] for g in p3)
    assert not all(same(a, b) for a, b in zip(p1, p3))
    g = p1[0]
    ctype = np.minimum(np.abs(g['src'].astype(int) - g['dst'].astype(int))
                       // 6, 2)
    assert np.array_equal(g['edge']['ctype'], ctype.astype(np.float32))
    plain = make_proteins(5, 3, 20, 35, contact_class=False)
    assert all(set(g['edge']) == {'length'} for g in plain)
    assert all(np.array_equal(a['edge']['length'], b['edge']['length'])
               for a, b in zip(p1, plain))


def test_heavy_counts_follow_the_histogram():
    """Largest remainders: the counts sum to n and each lies within one of
    its share; the 1024 molecules of the Gram are mostly of 7 heavy
    atoms."""
    for n in (1, 6, 256, 1024):
        counts = heavy_counts(n, HIST)
        assert len(counts) == n and list(counts) == sorted(counts)
        total = sum(c for _, c in HIST)
        for h, c in HIST:
            assert abs((counts == h).sum() - c / total * n) < 1
    assert (heavy_counts(1024, HIST) == 7).sum() == 824
    assert list(heavy_counts(5, [[2, 1], [3, 1]])) == [2, 2, 3, 3, 3]


def test_adjacency_is_the_programs():
    """The frozen rule against ``Graph.from_ase`` on the same atoms."""
    import torch
    from graphdot_tpu_torch.dataset._atoms import make_atoms
    from graphdot_tpu_torch.graph import Graph
    from h100_bench.molecules import relax, valence_graph
    rng = np.random.default_rng(4)
    topologies = [valence_graph(rng, n) for n in (3, 5, 7)]
    numbers, pos, _ = relax(topologies, 4, 'cpu')
    from h100_bench.adjacency import molecule_edges
    edges = molecule_edges(numbers, pos)
    for m, (src, dst, w, length) in enumerate(edges):
        n = len(topologies[m][0])
        atoms = make_atoms(numbers[m, :n].numpy(), pos[m, :n].numpy())
        g = Graph.from_ase(atoms, use_pbc=False)
        assert np.array_equal(np.asarray(g.edges['!i']), src)
        assert np.array_equal(np.asarray(g.edges['!j']), dst)
        assert np.allclose(np.asarray(g.edges['!w']), w, rtol=1e-6)
        assert np.allclose(np.asarray(g.edges['length']), length,
                           rtol=1e-6)
    assert torch.is_tensor(pos)
