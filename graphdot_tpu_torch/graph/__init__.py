"""Graph container and padded batches.

A copy of :mod:`graphdot_tpu.graph` (``Graph``, its frames, type inference
and NetworkX converters), which the port carries so that it imports
nothing of the JAX package. ``Graph`` has the JAX class's converters:
``from_networkx``, ``from_ase`` (:mod:`._from_ase`, with the adjacency
rules of :mod:`.adjacency`), ``from_rdkit`` (:mod:`._from_rdkit`, which
imports ``rdkit`` only to read a molecule's bond block), ``from_pymatgen``
(:mod:`._from_pymatgen`, through ``pymatgen.io.ase``) and ``from_smiles``,
which raises as JAX's does. What differs from the original:
``from_pymatgen`` hands ``use_pbc`` and ``adjacency`` to ``from_ase`` by
keyword, where the JAX module's positional call puts them into the wrong
parameters, and :func:`batch_graphs` packs with numpy only
(:mod:`.batch`). Graphs of both packages are interchangeable: each
package's batcher reads only ``nodes``, ``edges`` and ``cookie``.
"""
import copy as cp
import itertools as it

import numpy as np
import scipy.sparse

from ..util.cookie import VolatileCookie
from .frame import DataFrame
from .typetool import common_min_type, _is_scalar_dtype
from ._from_networkx import _from_networkx
from ._to_networkx import _to_networkx
from .batch import batch_graphs

__all__ = ['Graph', 'batch_graphs']

_SEQUENCE_TYPES = (list, tuple, np.ndarray)


def _as_frame(columns):
    return columns if isinstance(columns, DataFrame) else \
        DataFrame(columns)


def _shared_columns(graphs, component):
    """The common column set of one component across graphs; raises if
    any graph disagrees."""
    frames = [getattr(g, component) for g in graphs]
    wanted = set(frames[0].columns)
    for g, frame in zip(graphs, frames):
        if set(frame.columns) != wanted:
            raise TypeError(
                f'Graph {g} with {component} features '
                f'{set(frame.columns)} does not match the other graphs.')
    return frames, wanted


def _coerce_column(frames, key):
    """Cast one attribute column to a common concrete type across a list
    of frames (scalars via astype; ragged sequences element-wise)."""
    kinds = [f[key].concrete_type for f in frames]
    target = common_min_type.of_types(kinds)
    if target is None:
        target = common_min_type.of_types(kinds, coerce=False)
    if target is None:
        raise TypeError(
            f'Cannot unify attribute {key} containing mixed object types')
    if _is_scalar_dtype(target):
        for f in frames:
            f[key] = f[key].astype(target)
    elif target in _SEQUENCE_TYPES:
        scalar = common_min_type.of_values(
            it.chain.from_iterable(
                it.chain.from_iterable(f[key] for f in frames)))
        if scalar is None:
            raise TypeError(
                f'Cannot find a common type for elements in {key}.')
        for f in frames:
            f[key] = [np.asarray(seq, dtype=scalar) for seq in f[key]]


class Graph:
    """A graph as node and edge attribute frames.

    Parameters
    ----------
    nodes: dataframe
        One row per node; must contain column '!i'.
    edges: dataframe
        One row per edge; must contain columns '!i' and '!j', and
        optionally '!w' for edge weights.
    title: str
        A unique identifier of the graph.
    """

    def __init__(self, nodes, edges, title=''):
        self.title = str(title)
        self.nodes = _as_frame(nodes)
        self.edges = _as_frame(edges)
        for frame, required in ((self.nodes, '!i'), (self.edges, '!i'),
                                (self.edges, '!j')):
            assert required in frame

    def __repr__(self):
        return (f'{type(self).__name__}(nodes={self.nodes!r}, '
                f'edges={self.edges!r}, title={self.title!r})')

    @property
    def cookie(self):
        """Per-graph cache of derived device layouts, invalidated on
        mutation."""
        try:
            return self.__cookie
        except AttributeError:
            self.__cookie = VolatileCookie()
            return self.__cookie

    def copy(self, deep=False):
        """A (shallow by default) copy of the graph."""
        twin = type(self)(
            nodes=self.nodes.copy(deep=deep),
            edges=self.edges.copy(deep=deep),
            title=self.title)
        extras = {
            key: value for key, value in self.__dict__.items()
            if key not in ('nodes', 'edges', 'title')
        }
        twin.__dict__.update(cp.deepcopy(extras) if deep else extras)
        return twin

    def permute(self, perm, inplace=False):
        """Relabel the nodes by a permutation array (``perm[new] =
        old``)."""
        target = self if inplace else self.copy(deep=True)
        if inplace:
            self.cookie.clear()
        relabel = np.empty(len(perm), dtype=np.intp)
        relabel[np.asarray(perm)] = np.arange(len(perm))
        for frame, cols in ((target.nodes, ('!i',)),
                            (target.edges, ('!i', '!j'))):
            for c in cols:
                frame[c][:] = relabel[frame[c]]
        return target

    @property
    def adjacency_matrix(self):
        """The (weighted) symmetric adjacency matrix, sparse."""
        n = len(self.nodes)
        src = np.asarray(self.edges['!i'])
        dst = np.asarray(self.edges['!j'])
        w = np.asarray(self.edges['!w']) if '!w' in self.edges \
            else np.ones_like(src)
        return scipy.sparse.coo_matrix(
            (np.concatenate([w, w]),
             (np.concatenate([src, dst]), np.concatenate([dst, src]))),
            shape=(n, n))

    @property
    def laplacian(self):
        """The graph Laplacian D - A, sparse."""
        A = self.adjacency_matrix
        degree = np.ravel(A.sum(axis=0))
        return scipy.sparse.diags(degree, 0) - A

    @staticmethod
    def has_unified_types(graphs):
        """True if every graph shares the node/edge feature layout of the
        first; otherwise ('nodes'|'edges', first, offender)."""
        graphs = list(graphs)
        head, rest = graphs[0], graphs[1:]
        layouts = {
            c: getattr(head, c).rowtype() for c in ('nodes', 'edges')
        }
        for g in rest:
            for component, expected in layouts.items():
                if getattr(g, component).rowtype() != expected:
                    return (component, head, g)
        return True

    @classmethod
    def unify_datatype(cls, graphs, inplace=False):
        """Cast every attribute to one data type across all graphs."""
        for g in graphs:
            g.cookie.clear()
        if not inplace:
            graphs = [g.copy(deep=False) for g in graphs]
        for component in ('nodes', 'edges'):
            frames, columns = _shared_columns(graphs, component)
            for key in columns:
                _coerce_column(frames, key)
        if not inplace:
            return graphs

    @classmethod
    def disjoint_union(cls, graphs, title=None):
        """Disjoint union of a list of graphs: node/edge frames are
        concatenated with node indices offset per member."""
        graphs = list(graphs)
        if not graphs:
            raise ValueError('disjoint_union of an empty list')
        offsets = np.concatenate(
            [[0], np.cumsum([len(g.nodes) for g in graphs])])

        def _concat(frames, key, offset_key):
            parts = []
            for g_idx, f in enumerate(frames):
                v = np.asarray(f[key])
                if key in offset_key:
                    v = v + offsets[g_idx]
                parts.append(v)
            return np.concatenate(parts)

        node_frames, node_cols = _shared_columns(graphs, 'nodes')
        edge_frames, edge_cols = _shared_columns(graphs, 'edges')
        nodes = {k: _concat(node_frames, k, ('!i',)) for k in node_cols}
        edges = {k: _concat(edge_frames, k, ('!i', '!j'))
                 for k in edge_cols}
        return cls(
            nodes=nodes, edges=edges,
            title=title if title is not None else
            '|'.join(g.title for g in graphs)
        )

    # -- converters ---------------------------------------------------------

    @classmethod
    def from_networkx(cls, graph, weight=None):
        """Convert from a NetworkX ``Graph``."""
        return _from_networkx(cls, graph, weight)

    @classmethod
    def from_ase(cls, atoms, adjacency='default', use_charge=False,
                 use_pbc=True):
        """Convert from ASE atoms (or any object with their interface, such
        as ``dataset._atoms.SimpleAtoms``) to a molecular graph."""
        from ._from_ase import _from_ase
        return _from_ase(cls, atoms, adjacency, use_charge, use_pbc)

    @classmethod
    def from_pymatgen(cls, molecule, use_pbc=True, adjacency='default'):
        """Convert from a pymatgen molecule to a molecular graph."""
        from ._from_pymatgen import _from_pymatgen
        return _from_pymatgen(cls, molecule, use_pbc, adjacency)

    @classmethod
    def from_smiles(cls, smiles):
        """DEPRECATED and replaced by from_rdkit."""
        raise RuntimeError(
            'from_smiles has been removed, use from_rdkit instead.')

    @classmethod
    def from_rdkit(cls, mol, title=None, bond_type='order',
                   set_ring_list=True, set_ring_stereo=True):
        """Convert an RDKit molecule to a graph."""
        from ._from_rdkit import _from_rdkit
        return _from_rdkit(cls, mol, title=title, bond_type=bond_type,
                           set_ring_list=set_ring_list,
                           set_ring_stereo=set_ring_stereo)

    def to_networkx(self):
        """Convert to a NetworkX ``Graph`` with all node and edge
        attributes."""
        return _to_networkx(self)
