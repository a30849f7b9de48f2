"""Padded struct-of-arrays graph batches: the layout the solver reads.

A copy of :mod:`graphdot_tpu.graph.batch` with the numpy packer only. What
differs from the original: there is no native C++ packer and no
``use_native`` argument, ``batch_graphs(dense=False)`` leaves out the dense
arrays that only the solver's ``'dense'`` mode reads, and a graph's
packing is cached in ``g.cookie`` under a key of this package's own, so
that a graph passed through both packages never reads the other's
packing. Each graph is packed into
dense, padded numpy arrays:

- ``adj``: [n, n] symmetrized weighted adjacency (f32)
- ``degree``: [n] row sums (self-loops counted once)
- node features: dense [n] columns, or ([n, L], [n, L]) value/mask pairs
  for variable-length features
- edge features: dense symmetric [n, n] matrices (or [n, n, L] + mask)
- directed edge lists (``esrc``/``edst``/``ew``) for the edge-factored
  matvec of the solver.
"""
from collections import namedtuple

import numpy as np

_COOKIE_KEY = 'graphdot_tpu_torch.packed'

PackedGraph = namedtuple(
    'PackedGraph',
    ['n', 'adj', 'degree', 'node_feats', 'edge_feats',
     'esrc', 'edst', 'ew', 'n_edge', 'edge_elist_feats']
)

GraphBatch = namedtuple(
    'GraphBatch',
    ['n_node',        # [B] int32 true node counts
     'node_mask',     # [B, n] f32
     'adj',           # [B, n, n] f32
     'degree',        # [B, n] f32
     'node_feats',    # dict name -> [B, n](, L) (+ mask for var-length)
     'edge_feats',    # dict name -> [B, n, n](, L) (+ mask)
     'esrc',          # [B, M] int32 directed edge sources
     'edst',          # [B, M] int32 directed edge destinations
     'ew',            # [B, M] f32 directed edge weights (0 for padding)
     'n_edge',        # [B] int32 true directed edge counts
     'edge_elist_feats',  # dict name -> [B, M](, L) per-directed-edge
     ]
)


def _is_object_column(col):
    t = col.concrete_type
    return col.dtype.kind == 'O' or t in (list, tuple, np.ndarray)


def pack_graph(g):
    """Pack one Graph into dense numpy arrays; cached in ``g.cookie``."""
    if _COOKIE_KEY in g.cookie:
        return g.cookie[_COOKIE_KEY]

    n = len(g.nodes)
    # row r of the node frame describes node index g.nodes['!i'][r]
    # (permutations only rewrite the '!i'/'!j' columns); order features by
    # node index.
    node_order = np.argsort(np.asarray(g.nodes['!i'], dtype=np.int64))
    ei = np.asarray(g.edges['!i'], dtype=np.int64)
    ej = np.asarray(g.edges['!j'], dtype=np.int64)
    w = (np.asarray(g.edges['!w'], dtype=np.float32) if '!w' in g.edges
         else np.ones(len(ei), dtype=np.float32))

    adj = np.zeros((n, n), dtype=np.float32)
    adj[ei, ej] = w
    adj[ej, ei] = w
    degree = adj.sum(axis=1).astype(np.float32)

    node_feats = {}
    for key in g.nodes.columns:
        if key.startswith('!'):
            continue
        col = g.nodes[key][node_order]
        if _is_object_column(col):
            L = max((len(v) for v in col), default=1)
            vals = np.zeros((n, L), dtype=np.float32)
            mask = np.zeros((n, L), dtype=np.float32)
            for r, v in enumerate(col):
                v = np.asarray(v, dtype=np.float32)
                vals[r, :len(v)] = v
                mask[r, :len(v)] = 1.0
            node_feats[key] = (vals, mask)
        else:
            node_feats[key] = np.asarray(col, dtype=np.float32)

    edge_feats = {}
    for key in g.edges.columns:
        if key.startswith('!'):
            continue
        col = g.edges[key]
        if _is_object_column(col):
            L = max((len(v) for v in col), default=1)
            vals = np.zeros((n, n, L), dtype=np.float32)
            mask = np.zeros((n, n, L), dtype=np.float32)
            for r, v in enumerate(col):
                v = np.asarray(v, dtype=np.float32)
                i, j = ei[r], ej[r]
                vals[i, j, :len(v)] = v
                vals[j, i, :len(v)] = v
                mask[i, j, :len(v)] = 1.0
                mask[j, i, :len(v)] = 1.0
            edge_feats[key] = (vals, mask)
        else:
            mat = np.zeros((n, n), dtype=np.float32)
            cv = np.asarray(col, dtype=np.float32)
            mat[ei, ej] = cv
            mat[ej, ei] = cv
            edge_feats[key] = mat

    # directed edge list: both orientations for off-diagonal edges,
    # self-loops once; weight 0 marks padding downstream.
    off = ei != ej
    esrc = np.concatenate([ei, ej[off]]).astype(np.int32)
    edst = np.concatenate([ej, ei[off]]).astype(np.int32)
    ew = np.concatenate([w, w[off]]).astype(np.float32)

    edge_elist_feats = {}
    for key in g.edges.columns:
        if key.startswith('!'):
            continue
        col = g.edges[key]
        if _is_object_column(col):
            L = max((len(v) for v in col), default=1)
            vals = np.zeros((len(col), L), dtype=np.float32)
            mask = np.zeros((len(col), L), dtype=np.float32)
            for r, v in enumerate(col):
                v = np.asarray(v, dtype=np.float32)
                vals[r, :len(v)] = v
                mask[r, :len(v)] = 1.0
            edge_elist_feats[key] = (
                np.concatenate([vals, vals[off]]),
                np.concatenate([mask, mask[off]]),
            )
        else:
            cv = np.asarray(col, dtype=np.float32)
            edge_elist_feats[key] = np.concatenate([cv, cv[off]])

    packed = PackedGraph(
        n=n, adj=adj, degree=degree, node_feats=node_feats,
        edge_feats=edge_feats, esrc=esrc, edst=edst, ew=ew,
        n_edge=len(esrc), edge_elist_feats=edge_elist_feats
    )
    g.cookie[_COOKIE_KEY] = packed
    return packed


def _round_up(x, m):
    return max(m, -(-x // m) * m)


def _pad_leaf(arr, shape):
    """Zero-pad a numpy array up to ``shape``."""
    pads = [(0, s - d) for s, d in zip(shape, arr.shape)]
    return np.pad(arr, pads)


def batch_graphs(graphs, n_pad=None, m_pad=None, node_align=8,
                 edge_align=8, dense=True):
    """Stack a list of graphs into one padded GraphBatch (numpy arrays).

    Parameters
    ----------
    graphs: list of Graph
    n_pad, m_pad: int or None
        Explicit padded node / directed-edge counts; rounded-up maxima by
        default. Pass shared values across calls to give every batch
        the same shapes.
    dense: bool
        Stack the dense ``adj`` and ``edge_feats``, which only the solver's
        ``'dense'`` mode reads; without them both fields are None.
    """
    packed = [pack_graph(g) for g in graphs]
    B = len(packed)
    n_max = max(p.n for p in packed)
    m_max = max(p.n_edge for p in packed)
    n_pad = n_pad or _round_up(n_max, node_align)
    m_pad = m_pad or _round_up(m_max, edge_align)

    n_node = np.array([p.n for p in packed], dtype=np.int32)
    n_edge = np.array([p.n_edge for p in packed], dtype=np.int32)

    node_mask = np.zeros((B, n_pad), dtype=np.float32)
    for b, p in enumerate(packed):
        node_mask[b, :p.n] = 1.0

    adj = np.stack([_pad_leaf(p.adj, (n_pad, n_pad)) for p in packed]) \
        if dense else None
    degree = np.stack([_pad_leaf(p.degree, (n_pad,)) for p in packed])

    def stack_feats(feats_list, base_shape_of):
        keys = feats_list[0].keys()
        out = {}
        for key in keys:
            first = feats_list[0][key]
            if isinstance(first, tuple):
                L_pad = max(f[key][0].shape[-1] for f in feats_list)
                shape = base_shape_of(L_pad)
                vals = np.stack([
                    _pad_leaf(f[key][0], shape) for f in feats_list
                ])
                mask = np.stack([
                    _pad_leaf(f[key][1], shape) for f in feats_list
                ])
                out[key] = (vals, mask)
            else:
                shape = base_shape_of(None)
                out[key] = np.stack([
                    _pad_leaf(f[key], shape) for f in feats_list
                ])
        return out

    node_feats = stack_feats(
        [p.node_feats for p in packed],
        lambda L: (n_pad,) if L is None else (n_pad, L)
    )
    edge_feats = stack_feats(
        [p.edge_feats for p in packed],
        lambda L: (n_pad, n_pad) if L is None else (n_pad, n_pad, L)
    ) if dense else None

    esrc = np.stack([_pad_leaf(p.esrc, (m_pad,)) for p in packed])
    edst = np.stack([_pad_leaf(p.edst, (m_pad,)) for p in packed])
    ew = np.stack([_pad_leaf(p.ew, (m_pad,)) for p in packed])

    edge_elist_feats = stack_feats(
        [p.edge_elist_feats for p in packed],
        lambda L: (m_pad,) if L is None else (m_pad, L)
    )

    return GraphBatch(
        n_node=n_node, node_mask=node_mask, adj=adj, degree=degree,
        node_feats=node_feats, edge_feats=edge_feats,
        esrc=esrc, edst=edst, ew=ew, n_edge=n_edge,
        edge_elist_feats=edge_elist_feats
    )
