"""The port's graph reordering (``graphdot_tpu_torch.graph.reorder``, a copy
of the JAX package's) against the original, on the graphs of
``tests/test_graph.py``: the same permutations from ``rcm``, ``pbr`` and
``PbrMnom``, and the same tile counts."""
import networkx as nx
import numpy as np
import pytest
import scipy.sparse

from graphdot_tpu.graph import Graph as JaxGraph
from graphdot_tpu.graph.reorder import pbr as jax_pbr, rcm as jax_rcm
from graphdot_tpu.graph.reorder.mnom import PbrMnom as JaxPbrMnom
from graphdot_tpu.graph.reorder.pbr import _tile_count as jax_tile_count

from graphdot_tpu_torch.graph import Graph
from graphdot_tpu_torch.graph.reorder import pbr, rcm
from graphdot_tpu_torch.graph.reorder.mnom import PbrMnom
from graphdot_tpu_torch.graph.reorder.pbr import _tile_count

#: the graphs of test_rcm_and_pbr and test_pbr_never_worse_than_rcm_on_nws
NX_GRAPHS = {
    'cycle16': lambda: nx.cycle_graph(16),
    'nws64': lambda: nx.newman_watts_strogatz_graph(64, 6, 0.1, seed=1),
    'nws100': lambda: nx.newman_watts_strogatz_graph(100, 4, 0.05, seed=2),
}


@pytest.mark.parametrize('name', NX_GRAPHS)
def test_rcm_and_pbr_match_jax(name):
    g = Graph.from_networkx(NX_GRAPHS[name]())
    gj = JaxGraph.from_networkx(NX_GRAPHS[name]())
    n = len(g.nodes)
    for ours, theirs in ((rcm, jax_rcm), (pbr, jax_pbr)):
        perm = ours(g)
        np.testing.assert_array_equal(perm, theirs(gj))
        assert sorted(perm) == list(range(n))
        g2 = g.permute(perm)
        assert g2.adjacency_matrix.sum() == g.adjacency_matrix.sum()
    A = g.adjacency_matrix.tocsr()
    c_pbr = _tile_count(A, pbr(g))
    assert c_pbr == jax_tile_count(A, jax_pbr(gj))
    assert c_pbr <= _tile_count(A, rcm(g))


def planted_clusters():
    """The planted 8-clusters of test_mnom_recursive_bisection."""
    rng = np.random.default_rng(0)
    n, t = 96, 8
    perm_true = rng.permutation(n)
    rows, cols = [], []
    for c in range(n // t):
        members = perm_true[c * t:(c + 1) * t]
        for a in range(t):
            for b in range(a + 1, t):
                if rng.random() < 0.8:
                    rows.append(members[a])
                    cols.append(members[b])
    for _ in range(20):
        i, j = rng.integers(0, n, 2)
        if i != j:
            rows.append(i)
            cols.append(j)
    A = scipy.sparse.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n))
    return ((A + A.T) > 0).astype(np.int8).tocsr()


def test_mnom_matches_jax():
    A = planted_clusters()
    coo = A.tocoo()
    n = A.shape[0]
    perm = PbrMnom(tilesize=8)(coo.row, coo.col, n, n)
    np.testing.assert_array_equal(
        perm, JaxPbrMnom(tilesize=8)(coo.row, coo.col, n, n))
    assert _tile_count(A, perm) < _tile_count(A, np.arange(n)) / 2
    assert list(PbrMnom(tilesize=8)([0, 1], [1, 0], 3, 3)) == [0, 1, 2]
