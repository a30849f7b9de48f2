"""The port's RDKit and pymatgen adaptors against the JAX package's, on
the CPU, through duck-typed molecule fakes (a copy of those of
``tests/test_rdkit.py``; neither package is needed).

``_from_rdkit`` and its helpers touch a narrow, documented API surface
(atoms, bonds, ring info, molblock export); a fake ``rdkit.Chem`` module is
injected for the two functions that import it lazily. The port's
``get_ringlist``, ``get_bond_orientation_dict``, ``get_atom_ring_stereo``,
``FunctionalGroup`` ordering and ``Graph.from_rdkit`` are held to JAX's,
node and edge frames equal, on a substituted ring, two fused rings and a
ring of 104 atoms (whose V2000 bond block runs its fields together).
``from_pymatgen`` goes through a faked ``pymatgen.io.ase``; the port passes
``use_pbc`` and ``adjacency`` to ``from_ase`` by keyword, where the JAX
module's positional call puts them into ``adjacency`` and ``use_charge``.
"""
import itertools
import sys
import types

import numpy as np
import pytest

from graphdot_tpu.dataset._atoms import SimpleAtoms  # noqa: E402
from graphdot_tpu.graph import Graph as JaxGraph  # noqa: E402
from graphdot_tpu.graph import _from_pymatgen as jax_pymatgen  # noqa: E402
from graphdot_tpu.graph import _from_rdkit as jax_rdkit  # noqa: E402

from graphdot_tpu_torch.graph import Graph  # noqa: E402
from graphdot_tpu_torch.graph import _from_pymatgen  # noqa: E402
from graphdot_tpu_torch.graph import _from_rdkit  # noqa: E402


class FakeAtom:
    def __init__(self, mol, idx, z, charge=0, hcount=0, hybrid=3,
                 aromatic=False, chiral=0):
        self._mol = mol
        self._idx = idx
        self._z = z
        self._charge = charge
        self._hcount = hcount
        self._hybrid = hybrid
        self._aromatic = aromatic
        self._chiral = chiral

    def GetIdx(self):
        return self._idx

    def GetAtomicNum(self):
        return self._z

    def GetFormalCharge(self):
        return self._charge

    def GetTotalNumHs(self):
        return self._hcount

    def GetHybridization(self):
        return self._hybrid

    def GetIsAromatic(self):
        return self._aromatic

    def GetChiralTag(self):
        return self._chiral

    def IsInRing(self):
        return any(
            self._idx in ring for ring in self._mol._rings
        )

    def GetNeighbors(self):
        out = []
        for b in self._mol._bonds:
            if b._i == self._idx:
                out.append(self._mol._atoms[b._j])
            elif b._j == self._idx:
                out.append(self._mol._atoms[b._i])
        return out

    def GetBonds(self):
        return [
            b for b in self._mol._bonds
            if self._idx in (b._i, b._j)
        ]


_SINGLE = object()          # sentinel playing rdkit's BondType.SINGLE


class FakeBond:
    def __init__(self, mol, i, j, order=1.0, wedge=0, aromatic=False,
                 conjugated=False, stereo=0):
        self._mol = mol
        self._i, self._j = i, j
        self._order = order
        self.wedge = wedge
        self._aromatic = aromatic
        self._conjugated = conjugated
        self._stereo = stereo

    def GetBeginAtomIdx(self):
        return self._i

    def GetEndAtomIdx(self):
        return self._j

    def GetBeginAtom(self):
        return self._mol._atoms[self._i]

    def GetEndAtom(self):
        return self._mol._atoms[self._j]

    def GetBondTypeAsDouble(self):
        return self._order

    def GetBondType(self):
        return _SINGLE if self._order == 1.0 else self._order

    def GetIsAromatic(self):
        return self._aromatic

    def GetIsConjugated(self):
        return self._conjugated

    def GetStereo(self):
        return self._stereo


class FakeRingInfo:
    def __init__(self, rings):
        self._rings = rings

    def AtomRings(self):
        return self._rings


class FakeMol:
    def __init__(self, atoms, bonds, rings=()):
        self._atoms = [FakeAtom(self, i, **a) for i, a in enumerate(atoms)]
        self._bonds = [FakeBond(self, *b[:2], **b[2]) for b in bonds]
        self._rings = tuple(rings)

    def GetAtoms(self):
        return self._atoms

    def GetBonds(self):
        return self._bonds

    def GetNumAtoms(self):
        return len(self._atoms)

    def GetAtomWithIdx(self, i):
        return self._atoms[i]

    def GetBondBetweenAtoms(self, i, j):
        for b in self._bonds:
            if {b._i, b._j} == {i, j}:
                return b
        return None

    def GetRingInfo(self):
        return FakeRingInfo(self._rings)

    def molblock(self):
        """V2000-style bond block carrying the wedge flags."""
        lines = ['', '  fake', '',
                 f'{len(self._atoms):>3d}{len(self._bonds):>3d}'
                 '  0  0  0  0  0  0  0  0999 V2000']
        for _ in self._atoms:
            lines.append(
                '    0.0000    0.0000    0.0000 C   0  0  0  0  0')
        for b in self._bonds:
            order = int(b._order)
            lines.append(
                f'{b._i + 1:>3d}{b._j + 1:>3d}{order:>3d}{b.wedge:>3d}')
        lines.append('M  END')
        return '\n'.join(lines)


@pytest.fixture
def fake_rdkit(monkeypatch):
    """Install a minimal fake 'rdkit.Chem.AllChem' for the two functions
    that lazily import it (molblock export + BondType.SINGLE)."""
    allchem = types.SimpleNamespace(
        BondType=types.SimpleNamespace(SINGLE=_SINGLE),
        MolToMolBlock=lambda mol, **kw: mol.molblock(),
    )
    chem = types.ModuleType('rdkit.Chem')
    chem.AllChem = allchem
    rdkit = types.ModuleType('rdkit')
    rdkit.Chem = chem
    monkeypatch.setitem(sys.modules, 'rdkit', rdkit)
    monkeypatch.setitem(sys.modules, 'rdkit.Chem', chem)
    return allchem


def _ring_mol():
    """Cyclopentane with an 'up' methyl on atom 0 and a 'down' oxygen on
    atom 2."""
    C = dict(z=6, hcount=2)
    atoms = [C, C, C, C, C, dict(z=6, hcount=3), dict(z=8, hcount=1)]
    bonds = (
        [(i, (i + 1) % 5, {}) for i in range(5)]        # the ring
        + [(0, 5, dict(wedge=1)), (2, 6, dict(wedge=6))]
    )
    return FakeMol(atoms, bonds, rings=((0, 1, 2, 3, 4),))




@pytest.fixture
def fake_rdkit(monkeypatch):
    """Install a minimal fake 'rdkit.Chem.AllChem' for the two functions
    that lazily import it (molblock export + BondType.SINGLE)."""
    allchem = types.SimpleNamespace(
        BondType=types.SimpleNamespace(SINGLE=_SINGLE),
        MolToMolBlock=lambda mol, **kw: mol.molblock(),
    )
    chem = types.ModuleType('rdkit.Chem')
    chem.AllChem = allchem
    rdkit = types.ModuleType('rdkit')
    rdkit.Chem = chem
    monkeypatch.setitem(sys.modules, 'rdkit', rdkit)
    monkeypatch.setitem(sys.modules, 'rdkit.Chem', chem)
    return allchem


def ring_mol():
    """Cyclopentane with an 'up' methyl on atom 0 and a 'down' oxygen on
    atom 2 (``tests/test_rdkit.py``)."""
    C = dict(z=6, hcount=2)
    atoms = [C, C, C, C, C, dict(z=6, hcount=3), dict(z=8, hcount=1)]
    bonds = (
        [(i, (i + 1) % 5, {}) for i in range(5)]        # the ring
        + [(0, 5, dict(wedge=1)), (2, 6, dict(wedge=6))]
    )
    return FakeMol(atoms, bonds, rings=((0, 1, 2, 3, 4),))


def fused_mol():
    """A six- and a five-membered ring sharing the bond 0-5 (atoms in both
    rings carry two ring sizes), a nitrogen and a double bond in the ring,
    aromatic and conjugated flags, a charged oxygen, a chiral tag outside
    the rings, an up and a down substituent on one atom (ranked by their
    functional groups), and a wedge on a ring bond."""
    C = dict(z=6, hcount=1)
    atoms = ([C] * 5 + [dict(z=7, hcount=0, aromatic=True)]
             + [C] * 3
             + [dict(z=6, hcount=3, chiral=1), dict(z=8, charge=-1),
                dict(z=6, hcount=2), dict(z=9), dict(z=17)])
    bonds = (
        [(i, i + 1, {}) for i in range(5)] + [(0, 5, {})]   # six-ring
        + [(5, 6, dict(order=1.5, aromatic=True, conjugated=True)),
           (6, 7, dict(order=2.0, stereo=2)), (7, 8, {}),
           (8, 0, dict(wedge=6))]                            # five-ring
        + [(2, 9, dict(wedge=1)), (2, 11, dict(wedge=6)),
           (11, 12, {}), (3, 10, {}), (4, 13, dict(wedge=1))])
    return FakeMol(atoms, bonds, rings=((0, 1, 2, 3, 4, 5),
                                        (0, 5, 6, 7, 8)))


def big_ring_mol(n=104):
    """A ring of ``n`` carbons with a wedged substituent on every 25th
    atom: atom indices beyond 99 run the V2000 bond block's fields
    together."""
    atoms = [dict(z=6, hcount=2)] * n
    bonds = [(i, (i + 1) % n, {}) for i in range(n)]
    for s, i in enumerate(range(0, n, 25)):
        atoms = atoms + [dict(z=8 if s % 2 else 6, hcount=1)]
        bonds.append((i, len(atoms) - 1, dict(wedge=1 if s % 2 else 6)))
    return FakeMol(atoms, bonds, rings=(tuple(range(n)),))


MOLECULES = {'ring': ring_mol, 'fused': fused_mol, 'big_ring': big_ring_mol}


def _as_plain(value):
    """A frame's value as plain Python, lists for sequences."""
    if isinstance(value, (list, tuple, np.ndarray)):
        return [_as_plain(v) for v in value]
    return value.item() if isinstance(value, np.generic) else value


def _assert_graph_equal(g, jg, same_title=True):
    """Frames equal value by value, with their dtypes; the titles too
    unless ``from_ase`` made them (it appends a random id)."""
    assert type(g) is Graph
    assert g.title == jg.title if same_title else \
        g.title.split()[:2] == jg.title.split()[:2]
    for part in ('nodes', 'edges'):
        frame, jframe = getattr(g, part), getattr(jg, part)
        assert list(frame.columns) == list(jframe.columns), part
        for col in jframe.columns:
            a, b = np.asarray(frame[col]), np.asarray(jframe[col])
            assert a.dtype == b.dtype, (part, col)
            assert _as_plain(list(frame[col])) == \
                _as_plain(list(jframe[col])), (part, col)


@pytest.mark.parametrize('name', sorted(MOLECULES))
def test_ringlist_matches_jax(name):
    mol = MOLECULES[name]()
    assert _from_rdkit.get_ringlist(mol) == jax_rdkit.get_ringlist(mol)


@pytest.mark.parametrize('name', sorted(MOLECULES))
def test_bond_orientation_and_ring_stereo_match_jax(fake_rdkit, name):
    mol = MOLECULES[name]()
    bod = _from_rdkit.get_bond_orientation_dict(mol)
    assert bod == jax_rdkit.get_bond_orientation_dict(mol)
    assert len(bod) == len(mol.GetBonds())
    assert sum(1 for v in bod.values() if v) == \
        sum(1 for b in mol.GetBonds() if b.wedge)
    for ring in mol.GetRingInfo().AtomRings():
        for i in ring:
            atom = mol.GetAtomWithIdx(i)
            got = _from_rdkit.get_atom_ring_stereo(
                mol, atom, ring, bond_orientation_dict=bod)
            assert got == jax_rdkit.get_atom_ring_stereo(
                mol, atom, ring, bond_orientation_dict=bod), (ring, i)
            assert got == _from_rdkit.get_atom_ring_stereo(mol, atom, ring)


@pytest.mark.parametrize('name', sorted(MOLECULES))
def test_functional_group_ordering_matches_jax(name):
    """Every directed bond's functional group at depths 1 and 5: the same
    rank lists as JAX's, and the same order between any two groups."""
    mol = MOLECULES[name]()
    for depth in (1, 5):
        groups, jgroups = [], []
        for b in mol.GetBonds()[:40]:
            for a0, a1 in ((b.GetBeginAtom(), b.GetEndAtom()),
                           (b.GetEndAtom(), b.GetBeginAtom())):
                groups.append(_from_rdkit.FunctionalGroup(mol, a0, a1,
                                                          depth))
                jgroups.append(jax_rdkit.FunctionalGroup(mol, a0, a1,
                                                         depth))
        for g, jg in zip(groups, jgroups):
            assert g.get_rank_list() == jg.get_rank_list()
        for (g, jg), (h, jh) in itertools.combinations(
                zip(groups, jgroups), 2):
            assert (g < h, g == h, g > h) == (jg < jh, jg == jh, jg > jh)


OPTIONS = [dict(), dict(set_ring_stereo=False), dict(set_ring_list=False),
           dict(bond_type='type', set_ring_stereo=False)]


@pytest.mark.parametrize('name,options', [
    (name, options) for name in sorted(MOLECULES) for options in OPTIONS
    if not (name == 'fused' and 'bond_type' in options)])
def test_from_rdkit_matches_jax(fake_rdkit, name, options):
    """``Graph.from_rdkit`` of either package: node and edge frames
    equal, ring stereo included. (The fused molecule's bond types mix the
    fake's SINGLE sentinel with floats, which neither package's frame
    takes: the next test.)"""
    mol = MOLECULES[name]()
    g = Graph.from_rdkit(mol, title=name, **options)
    jg = JaxGraph.from_rdkit(mol, title=name, **options)
    _assert_graph_equal(g, jg)
    _assert_graph_equal(_from_rdkit._from_rdkit(Graph, mol, title=name,
                                                **options), jg)
    assert len(g.nodes) == mol.GetNumAtoms()
    assert len(g.edges) == len(mol.GetBonds())
    if options.get('set_ring_stereo', True):
        assert np.any(np.asarray(g.edges['ring_stereo']) != 0)


def test_from_rdkit_mixed_bond_types_raise_as_jax(fake_rdkit):
    errors = []
    for cls in (Graph, JaxGraph):
        with pytest.raises(TypeError) as info:
            cls.from_rdkit(fused_mol(), bond_type='type')
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_ring_stereo_values(fake_rdkit):
    """The values of ``tests/test_rdkit.py``: up at 0, down at 2; the bonds
    walking 0->2 get 1*(-1)/2, those walking 2->0 the long way
    (-1)*1/3."""
    g = Graph.from_rdkit(ring_mol(), title='ring')
    edges = {
        (int(i), int(j)): float(s) for i, j, s in zip(
            g.edges['!i'], g.edges['!j'], g.edges['ring_stereo'])
    }
    assert edges[(0, 1)] == edges[(1, 2)] == pytest.approx(-0.5)
    for e in ((2, 3), (3, 4), (0, 4)):
        assert edges[e] == pytest.approx(-1 / 3)
    assert edges[(0, 5)] == 0 and edges[(2, 6)] == 0


def _fake_pymatgen(monkeypatch, atoms):
    """A fake ``pymatgen.io.ase`` whose adaptor returns ``atoms``."""
    ase_mod = types.ModuleType('pymatgen.io.ase')
    ase_mod.AseAtomsAdaptor = types.SimpleNamespace(
        get_atoms=lambda molecule: atoms)
    io_mod = types.ModuleType('pymatgen.io')
    io_mod.ase = ase_mod
    pmg = types.ModuleType('pymatgen')
    pmg.io = io_mod
    monkeypatch.setitem(sys.modules, 'pymatgen', pmg)
    monkeypatch.setitem(sys.modules, 'pymatgen.io', io_mod)
    monkeypatch.setitem(sys.modules, 'pymatgen.io.ase', ase_mod)


@pytest.mark.parametrize('use_pbc', [True, False])
def test_from_pymatgen_passes_its_arguments_by_keyword(monkeypatch,
                                                       use_pbc):
    """Through a fake ``from_ase`` with the real signature, the port's
    ``use_pbc`` and ``adjacency`` reach their own parameters; the JAX
    module's positional call puts ``use_pbc`` into ``adjacency`` and
    ``adjacency`` into ``use_charge``."""
    atoms = object()
    _fake_pymatgen(monkeypatch, atoms)

    class FakeGraphCls:
        seen = []

        @classmethod
        def from_ase(cls, atoms, adjacency='default', use_charge=False,
                     use_pbc=True):
            cls.seen.append(dict(atoms=atoms, adjacency=adjacency,
                                 use_charge=use_charge, use_pbc=use_pbc))
            return len(cls.seen)

    marker = ('tent2', 'vdw_radius', 0.75)
    assert _from_pymatgen._from_pymatgen(
        FakeGraphCls, object(), use_pbc=use_pbc, adjacency=marker) == 1
    jax_pymatgen._from_pymatgen(FakeGraphCls, object(), use_pbc=use_pbc,
                                adjacency=marker)
    port, jax = FakeGraphCls.seen
    assert port == dict(atoms=atoms, adjacency=marker, use_charge=False,
                        use_pbc=use_pbc)
    assert jax == dict(atoms=atoms, adjacency=use_pbc, use_charge=marker,
                       use_pbc=True)


def test_from_pymatgen_builds_the_from_ase_graph(monkeypatch):
    """``Graph.from_pymatgen`` of a molecule whose adaptor gives a water
    molecule: the graph of ``Graph.from_ase`` on those atoms (its three
    pairs within the default adjacency), as the JAX
    package builds it."""
    atoms = SimpleAtoms([8, 1, 1], [[0.0, 0.0, 0.0], [0.96, 0.0, 0.0],
                                    [-0.24, 0.93, 0.0]])
    _fake_pymatgen(monkeypatch, atoms)
    g = Graph.from_pymatgen(object(), use_pbc=False)
    _assert_graph_equal(g, JaxGraph.from_ase(atoms, use_pbc=False), False)
    _assert_graph_equal(g, Graph.from_ase(atoms, use_pbc=False), False)
    assert len(g.nodes) == 3 and len(g.edges) == 3


def test_from_smiles_raises_as_jax():
    for cls in (Graph, JaxGraph):
        with pytest.raises(RuntimeError, match='use from_rdkit instead'):
            cls.from_smiles('CCO')
