"""Adaptor for RDKit molecule objects; a copy of
``graphdot_tpu/graph/_from_rdkit.py`` (the reference's
``graphdot/graph/_from_rdkit.py:215-280``).

Produces the same feature set as the reference:

- node features: atomic_number, charge, hcount, hybridization, aromatic,
  chiral, ring_list
- edge features: order (or type), aromatic, conjugated, stereo, ring_stereo

The ring-stereo inference (up/down orientation of ring substituents via
molblock wedge parsing and breadth-first functional-group comparison) is
re-implemented without the ``treelib`` dependency. It keeps the JAX copy's
two departures from the reference, both bug fixes: (a) the V2000 bond
block is parsed by its fixed 3-character columns, so molecules with >= 99
atoms (where fields run together, e.g. ``  1100  1  0``) keep their wedge
flags, where the reference's character-class regex
(``_from_rdkit.py:103``) matches nothing at all; (b) orientation lookups
normalize the atom pair to (min, max), matching how the dictionary is
keyed. ``rdkit.Chem`` is imported only by the two functions that need it.
"""
import networkx as nx
import numpy as np

from ._from_networkx import _from_networkx


class FunctionalGroup:
    """A functional group reachable from ``atom0`` through the directed
    bond ``atom0 -> atom1``, represented as a breadth-first layered tree
    used solely for canonical-rank comparison (reference
    ``_from_rdkit.py:12``)."""

    def __init__(self, mol, atom0, atom1, depth=5):
        order0 = mol.GetBondBetweenAtoms(
            atom0.GetIdx(), atom1.GetIdx()
        ).GetBondTypeAsDouble()
        # each entry: (tag, atom, parent_idx); breadth-first expansion
        root = ([atom0.GetAtomicNum(), order0], atom0, None)
        first = ([atom1.GetAtomicNum(), order0], atom1, atom0.GetIdx())
        layers = [[root], [first]]
        for _ in range(depth):
            frontier = []
            for tag, atom, parent in layers[-1]:
                for nbr in atom.GetNeighbors():
                    if nbr.GetIdx() == parent:
                        continue
                    order = mol.GetBondBetweenAtoms(
                        nbr.GetIdx(), atom.GetIdx()
                    ).GetBondTypeAsDouble()
                    frontier.append((
                        [nbr.GetAtomicNum(), order], nbr, atom.GetIdx()
                    ))
            if not frontier:
                break
            layers.append(frontier)
        self._layers = layers

    def get_rank_list(self):
        rank = []
        for layer in self._layers:
            for tag, _, _ in sorted(layer, key=lambda t: t[0],
                                    reverse=True):
                rank += tag
        return rank

    def __eq__(self, other):
        return self.get_rank_list() == other.get_rank_list()

    def __lt__(self, other):
        return self.get_rank_list() < other.get_rank_list()

    def __gt__(self, other):
        return self.get_rank_list() > other.get_rank_list()


def get_bond_orientation_dict(mol):
    """Wedge (1) / hash (6) flags of every bond, keyed by the sorted atom
    index pair, parsed from the fixed-width V2000 bond block."""
    from rdkit.Chem import AllChem as Chem
    lines = Chem.MolToMolBlock(
        mol, includeStereo=True, kekulize=False).splitlines()
    counts = lines[3]
    n_atoms, n_bonds = int(counts[0:3]), int(counts[3:6])
    flags = {}
    for line in lines[4 + n_atoms:4 + n_atoms + n_bonds]:
        i = int(line[0:3]) - 1
        j = int(line[3:6]) - 1
        stereo = int(line[9:12]) if len(line) >= 12 else 0
        flags[(min(i, j), max(i, j))] = stereo
    return flags


def get_atom_ring_stereo(mol, atom, ring_idx, depth=5,
                         bond_orientation_dict=None):
    """Whether an atom's larger substituent points up (+1), down (-1), or
    neither (0) relative to the ring plane."""
    from rdkit.Chem import AllChem as Chem

    if bond_orientation_dict is None:
        bond_orientation_dict = get_bond_orientation_dict(mol)

    neighbors = atom.GetNeighbors()
    if len(neighbors) == 2:
        return 0
    if len(neighbors) > 4:
        raise RuntimeError(
            'cannot deal with atom in a ring with more than 4 bonds')

    up_atom = down_atom = None
    ring_bond_tag = None
    for bond in atom.GetBonds():
        if bond.GetBondType() != Chem.BondType.SINGLE \
                and atom.GetAtomicNum() == 6:
            return 0
        i = bond.GetBeginAtom().GetIdx()
        j = bond.GetEndAtom().GetIdx()
        flag = bond_orientation_dict.get((min(i, j), max(i, j)))
        if i in ring_idx and j in ring_idx:
            if flag != 0:
                ring_bond_tag = flag
            continue
        if flag == 1:
            if up_atom is not None:
                raise RuntimeError('2 bonds oriented up')
            up_atom = mol.GetAtomWithIdx(j if i == atom.GetIdx() else i)
        elif flag == 6:
            if down_atom is not None:
                raise RuntimeError('2 bonds oriented down')
            down_atom = mol.GetAtomWithIdx(j if i == atom.GetIdx() else i)

    if up_atom is None and down_atom is None:
        return {1: 1, 6: -1}.get(ring_bond_tag, 0)
    if up_atom is None:
        return -1
    if down_atom is None:
        return 1
    fg_up = FunctionalGroup(mol, atom, up_atom, depth)
    fg_down = FunctionalGroup(mol, atom, down_atom, depth)
    return 1 if fg_up > fg_down else (-1 if fg_up < fg_down else 0)


def get_ringlist(mol):
    """Per-atom sorted list of sizes of rings the atom participates in
    ([0] for acyclic atoms)."""
    ringlist = [[] for _ in range(mol.GetNumAtoms())]
    for ring in mol.GetRingInfo().AtomRings():
        for i in ring:
            ringlist[i].append(len(ring))
    return [sorted(rings) if len(rings) else [0] for rings in ringlist]


def _assign_ring_stereo(mol, g):
    """Propagate the per-atom up/down tags around each ring onto its
    bonds: each bond between consecutive tagged atoms b..e receives
    tag_b * tag_e / arc_length."""
    orientation = get_bond_orientation_dict(mol)
    for ring_idx in mol.GetRingInfo().AtomRings():
        tags = np.array([
            get_atom_ring_stereo(
                mol, mol.GetAtomWithIdx(idx), ring_idx, depth=5,
                bond_orientation_dict=orientation)
            for idx in ring_idx
        ])
        anchors = np.flatnonzero(tags)
        size = len(ring_idx)
        for pos, b in enumerate(anchors):
            e = anchors[(pos + 1) % len(anchors)]
            length = (e - b) % size if e != b else size
            value = tags[b] * tags[e] / length
            for step in range(length):
                u = ring_idx[(b + step) % size]
                v = ring_idx[(b + step + 1) % size]
                g.edges[(min(u, v), max(u, v))]['ring_stereo'] = value


def _from_rdkit(cls, mol, title=None, bond_type='order',
                set_ring_list=True, set_ring_stereo=True):
    g = nx.Graph(title=title)

    ring_lists = get_ringlist(mol) if set_ring_list else None
    for i, atom in enumerate(mol.GetAtoms()):
        features = dict(
            atomic_number=atom.GetAtomicNum(),
            charge=atom.GetFormalCharge(),
            hcount=atom.GetTotalNumHs(),
            hybridization=atom.GetHybridization(),
            aromatic=atom.GetIsAromatic(),
            chiral=0 if atom.IsInRing() else atom.GetChiralTag(),
        )
        if ring_lists is not None:
            features['ring_list'] = ring_lists[i]
        g.add_node(i, **features)

    for bond in mol.GetBonds():
        features = dict(
            aromatic=bond.GetIsAromatic(),
            conjugated=bond.GetIsConjugated(),
            stereo=bond.GetStereo(),
        )
        if bond_type == 'order':
            features['order'] = bond.GetBondTypeAsDouble()
        else:
            features['type'] = bond.GetBondType()
        if set_ring_stereo:
            features['ring_stereo'] = 0
        g.add_edge(bond.GetBeginAtomIdx(), bond.GetEndAtomIdx(),
                   **features)

    if set_ring_stereo:
        _assign_ring_stereo(mol, g)
    return _from_networkx(cls, g)
