"""The port's graph input from atoms against the JAX package's:
``Graph.from_ase``, the adjacency rules, the atoms duck-type, ``load_qm7``
over the committed surrogate and the ``M3`` metric, array by array on the
same molecules, on the CPU.

``M3`` solves the product graphs with the port's kernel (here on the CPU).
Its scipy sparse-CG oracle ``_mlgk`` is held against the JAX ``M3``'s
(rtol 1e-9) and against the port kernel's nodal similarity on the same
graphs (rtol 1e-4, atol 1e-5, the check of
``tests/test_metric.py::test_m3_metric_and_oracle_crosscheck``); the
distance against the JAX ``M3``'s within the D limit of the maximin tests
(1e-4 where both distances exceed 0.01, else 5e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu.dataset import _atoms as jax_atoms  # noqa: E402
from graphdot_tpu.dataset.qm7_fixture import (  # noqa: E402
    load_qm7 as jax_load_qm7)
from graphdot_tpu.experimental.metric import M3 as JaxM3  # noqa: E402
from graphdot_tpu.graph import Graph as JaxGraph  # noqa: E402
from graphdot_tpu.graph.adjacency import (  # noqa: E402
    AtomicAdjacency as JaxAdjacency)
from graphdot_tpu.graph.adjacency._ptable import (  # noqa: E402
    get_length_scales as jax_length_scales)

from graphdot_tpu_torch.dataset import _atoms  # noqa: E402
from graphdot_tpu_torch.dataset.qm7_fixture import load_qm7  # noqa: E402
from graphdot_tpu_torch.experimental.metric import M3  # noqa: E402
from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.graph.adjacency import (  # noqa: E402
    AtomicAdjacency, CompactBell, Gaussian, Tent)
from graphdot_tpu_torch.graph.adjacency._ptable import (  # noqa: E402
    get_length_scales)
from graphdot_tpu_torch.kernel import MarginalizedGraphKernel  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Run torch on one thread (test processes run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_graph_equal(g, jg):
    for part in ('nodes', 'edges'):
        frame, jframe = getattr(g, part), getattr(jg, part)
        assert list(frame.columns) == list(jframe.columns), part
        for col in jframe.columns:
            a, b = np.asarray(frame[col]), np.asarray(jframe[col])
            assert a.dtype == b.dtype, (part, col)
            np.testing.assert_array_equal(a, b, err_msg=f'{part}.{col}')


@pytest.fixture(scope='module')
def qm7():
    """The 100 surrogate molecules in both packages."""
    mols, energy, source = load_qm7()
    jmols, jenergy, jsource = jax_load_qm7(real_path='no-such-qm7.mat')
    return mols, energy, source, jmols, jenergy, jsource


def test_load_qm7_matches_jax(qm7):
    mols, energy, source, jmols, jenergy, jsource = qm7
    assert source == jsource == 'surrogate'
    assert len(mols) == len(jmols) == 100
    np.testing.assert_array_equal(energy, jenergy)
    for m, jm in zip(mols, jmols):
        np.testing.assert_array_equal(m.get_atomic_numbers(),
                                      jm.get_atomic_numbers())
        np.testing.assert_array_equal(m.get_positions(), jm.get_positions())
        assert m.get_chemical_formula() == jm.get_chemical_formula()
    few, e, _ = load_qm7(n=7)
    assert len(few) == 7 and np.array_equal(e, energy[:7])


@pytest.mark.parametrize('adjacency', [
    'default', ('tent2', 'vdw_radius', 0.75), ('gaussian', 1.2, 1.0),
    ('compactbell4,2', 'covalent_radius', 1.5)])
def test_from_ase_matches_jax_on_the_surrogate(qm7, adjacency):
    mols, _, _, jmols, _, _ = qm7
    if adjacency == 'default':
        args, jargs = {}, {}
    else:
        shape, length, zoom = adjacency
        args = dict(adjacency=AtomicAdjacency(shape, length, zoom))
        jargs = dict(adjacency=JaxAdjacency(shape, length, zoom))
    step = 1 if adjacency == 'default' else 9
    for m, jm in zip(mols[::step], jmols[::step]):
        g = Graph.from_ase(m, use_pbc=False, **args)
        assert type(g) is Graph
        _assert_graph_equal(g, JaxGraph.from_ase(jm, use_pbc=False, **jargs))


def test_from_ase_with_charges_and_periodic_images():
    rng = np.random.default_rng(4)
    numbers = [6, 8, 1, 1, 7]
    positions = rng.uniform(0, 3.0, size=(5, 3))
    charges = rng.normal(size=5)
    atoms = _atoms.SimpleAtoms(numbers, positions, charges)
    jatoms = jax_atoms.SimpleAtoms(numbers, positions, charges)
    for a in (atoms, jatoms):
        a.pbc = np.array([True, False, True])
        a.cell = np.diag([4.0, 5.0, 4.5])
    adjacency = AtomicAdjacency('tent1', 'covalent_radius', 1.2)
    jadjacency = JaxAdjacency('tent1', 'covalent_radius', 1.2)
    for use_pbc in (True, False):
        g = Graph.from_ase(atoms, adjacency=adjacency, use_charge=True,
                           use_pbc=use_pbc)
        _assert_graph_equal(g, JaxGraph.from_ase(
            jatoms, adjacency=jadjacency, use_charge=True, use_pbc=use_pbc))
        assert 'charge' in g.nodes.columns


def test_from_ase_raises_without_bonds():
    atoms = _atoms.SimpleAtoms([1, 1], [[0, 0, 0], [50.0, 0, 0]])
    with pytest.raises(RuntimeError, match='no bonds'):
        Graph.from_ase(atoms, adjacency=AtomicAdjacency('tent1'),
                       use_pbc=False)


def test_make_atoms_falls_back_to_simple_atoms():
    a = _atoms.make_atoms([6, 1], [[0, 0, 0], [1.0, 0, 0]])
    b = jax_atoms.make_atoms([6, 1], [[0, 0, 0], [1.0, 0, 0]])
    assert type(a).__name__ == type(b).__name__
    assert len(a) == 2 and a.get_chemical_formula() == 'CH'


@pytest.mark.parametrize('name', ['vdw_radius', 'atomic_radius',
                                  'covalent_radius',
                                  'covalent_radius_cordero',
                                  'covalent_radius_pyykko'])
def test_length_tables_match_jax(name):
    got = get_length_scales(name)
    assert got.shape == (119,)
    np.testing.assert_array_equal(got, jax_length_scales(name))


def test_unknown_table_raises_the_jax_error():
    """Tables beyond the built-in ones need ``mendeleev``: the port raises
    the error the JAX module raises without that package."""
    with pytest.raises(ValueError) as port_error:
        get_length_scales('electronegativity')
    with pytest.raises(ValueError) as jax_error:
        jax_length_scales('electronegativity')
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(ValueError, match='mendeleev'):
        AtomicAdjacency(length_scale='electronegativity')


@pytest.mark.parametrize('shape,length,zoom', [
    ('tent1', 'vdw_radius', 1.0), ('tent3', 'covalent_radius', 0.75),
    ('gaussian', 'atomic_radius', 1.0), ('compactbell5,3', 1.4, 1.0)])
def test_adjacency_weights_and_cutoffs_match_jax(shape, length, zoom):
    adj, jadj = (cls(shape, length, zoom)
                 for cls in (AtomicAdjacency, JaxAdjacency))
    r = np.linspace(0.0, 12.0, 97)
    for z1, z2 in [(1, 1), (6, 8), (7, 16), (9, 6)]:
        np.testing.assert_array_equal(adj(z1, z2, r), jadj(z1, z2, r))
        assert adj(z1, z2, 0.9) == jadj(z1, z2, 0.9)
    elements = np.array([1, 6, 8])
    assert adj.cutoff(elements) == jadj.cutoff(elements)
    w = adj(6, 6, r)
    assert w.shape == r.shape and (w >= 0).all() and w[0] == 1.0
    if shape != 'gaussian':
        assert (w[r >= adj.cutoff(np.array([6]))] == 0).all()


def test_adjacency_shapes_and_their_errors():
    assert Tent(2).cutoff(1.5) == 4.5 and Gaussian().cutoff(1.0) == np.inf
    assert CompactBell(4, 2)(4.5, 1.5) == 0.0
    assert CompactBell(4, 2)(0.0, 1.5) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        Tent(0)
    with pytest.raises(ValueError):
        CompactBell(2, 2)
    with pytest.raises(ValueError, match='Unrecognizable'):
        AtomicAdjacency('triangle')


# ---------------------------------------------------------------------------
# M3
# ---------------------------------------------------------------------------


def _pairs(qm7):
    mols, _, _, jmols, _, _ = qm7
    return [((mols[a], mols[b]), (jmols[a], jmols[b]))
            for a, b in [(0, 1), (2, 7), (11, 11)]]


def _d_limit(a, b):
    """The D limit: 1e-4 where both distances exceed 0.01, else 5e-3."""
    return 1e-4 if min(a, b) > 0.01 else 5e-3


def _oracle_distance(m3, a, b):
    """M3's distance over its scipy solves (the JAX module's route)."""
    g1, g2 = m3._graphs(a, b)
    return M3._maximin(np.diagonal(m3._mlgk(g1, g1)), m3._mlgk(g1, g2),
                       np.diagonal(m3._mlgk(g2, g2)))


def test_m3_matches_jax(qm7):
    m3, jm3 = M3(q=0.05, device='cpu'), JaxM3(q=0.05)
    for (a, b), (ja, jb) in _pairs(qm7):
        want = jm3(ja, jb)
        assert _oracle_distance(m3, a, b) == pytest.approx(
            want, rel=1e-9, abs=1e-12)
        d = m3(a, b)
        assert abs(d - want) <= _d_limit(d, want)
        g, jg = (cls.from_ase(x, adjacency=m.adjacency)
                 for cls, x, m in ((Graph, a, m3), (JaxGraph, ja, jm3)))
        np.testing.assert_allclose(m3._mlgk(g, g), jm3._mlgk(jg, jg),
                                   rtol=1e-9)


def test_m3_with_charges_matches_jax():
    rng = np.random.default_rng(1)
    numbers = [6, 6, 8, 1, 1]
    pos = rng.normal(size=(5, 3)) * 1.2
    charges = rng.normal(size=5) * 0.3
    a = _atoms.SimpleAtoms(numbers, pos, charges)
    ja = jax_atoms.SimpleAtoms(numbers, pos, charges)
    b = _atoms.SimpleAtoms(numbers[:4], pos[:4] + 0.1, charges[:4])
    jb = jax_atoms.SimpleAtoms(numbers[:4], pos[:4] + 0.1, charges[:4])
    m3 = M3(use_charge=True, q=0.05, device='cpu')
    jm3 = JaxM3(use_charge=True, q=0.05)
    want = jm3(ja, jb)
    assert _oracle_distance(m3, a, b) == pytest.approx(want, rel=1e-9)
    d = m3(a, b)
    assert abs(d - want) <= _d_limit(d, want)
    assert m3(a, a) == pytest.approx(0.0, abs=1e-4)


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_m3_solve_matches_the_port_kernel(qm7, backend):
    """M3's scipy CG against the port kernel's nodal R on the same
    graphs (backend 'cuda' runs its kernels' plain twins on the CPU)."""
    m3 = M3(q=0.05, device='cpu')
    kernel = MarginalizedGraphKernel(m3.node_kernel, m3.edge_kernel, q=m3.q,
                                     backend=backend, device='cpu')
    for (a, b), _ in _pairs(qm7):
        g1, g2 = m3._graphs(a, b)
        R = kernel([g1], [g2], nodal=True)
        np.testing.assert_allclose(m3._mlgk(g1, g2), R, rtol=1e-4,
                                   atol=1e-5)


def test_m3_metric_properties():
    """The cases of ``tests/test_metric.py``: zero self-distance,
    symmetry, a positive distance between different molecules."""
    rng = np.random.default_rng(0)
    atoms1 = _atoms.make_atoms([6, 6, 8, 1], rng.normal(size=(4, 3)) * 1.2)
    atoms2 = _atoms.make_atoms([6, 7, 8], rng.normal(size=(3, 3)) * 1.2)
    m3 = M3(q=0.05, device='cpu')
    assert m3(atoms1, atoms1) == pytest.approx(0.0, abs=1e-4)
    d12 = m3(atoms1, atoms2)
    assert d12 > 0.01
    assert m3(atoms2, atoms1) == pytest.approx(d12, rel=1e-5)
