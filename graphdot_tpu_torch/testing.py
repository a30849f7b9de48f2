"""Synthetic graph sets for tests, benchmarks and dry runs: random
molecules and contact-map proteins (the same generators, seeds and
numbers as :mod:`graphdot_tpu.testing`), the categorical-edge protein set
of ``bench_protein.py``, and the edge cases of the streaming PCG kernel
(a hub graph, dead edges between live ones, odd edge counts, and the
shared-memory limits that give its other plans).
"""
import numpy as np

from .graph import Graph
from .graph.frame import DataFrame

__all__ = ['random_molecule_graph', 'random_molecule_set',
           'random_protein_graph', 'random_protein_set',
           'protein_niche_set', 'hub_molecule_graph', 'with_dead_edges',
           'stream_plan_kind', 'stream_limit_for']


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


def hub_molecule_graph(seed, n_atoms=40, hub_degree=36):
    """A random molecule graph of ``n_atoms`` atoms plus a hub atom bonded
    to ``hub_degree`` of them and an atom with no bond: one node of degree
    above 32 (a warp's width) and one of degree 0."""
    rng = np.random.default_rng(seed)
    g = random_molecule_graph(rng, n_atoms)
    n = len(g.nodes)
    friends = np.sort(rng.choice(n, size=hub_degree, replace=False))
    length = rng.uniform(1.0, 1.8, size=hub_degree).astype(np.float32)
    e = g.edges
    nodes = DataFrame({
        '!i': np.arange(n + 2),
        'element': np.concatenate([np.asarray(g.nodes['element']),
                                   np.array([6, 1], dtype=np.int8)])})
    edges = DataFrame({
        '!i': np.concatenate([np.asarray(e['!i']), friends]).astype(
            np.uint32),
        '!j': np.concatenate([np.asarray(e['!j']),
                              np.full(hub_degree, n)]).astype(np.uint32),
        '!w': np.concatenate([np.asarray(e['!w']), np.exp(
            -0.5 * (length - 1.4) ** 2).astype(np.float32)]),
        'length': np.concatenate([np.asarray(e['length']), length]),
    })
    return Graph(nodes, edges, title=f'hub-{n_atoms}-{hub_degree}')


def with_dead_edges(args, case):
    """The operands of a product-graph PCG solve, ``(T, esrc1, edst1,
    esrc2, edst2, *rest)`` with T [P, M1, M2] (a torch tensor and edge
    lists), with dead edges added: edges whose row (side 1) or column
    (side 2) of T is 0, each with the ends of a live edge next to it, so
    the system is the same and only the edge lists differ.

    ``'odd_m2'`` appends one to side 1 and three to side 2 (so M2 % 4 == 3
    where M2 % 4 was 0, and T's rows lie at every 4-byte offset of 16);
    ``'dead_between'`` puts one before side 1's first edge and before every
    third edge after it, and one before every fourth edge of side 2."""
    import torch
    T, esrc1, edst1, esrc2, edst2, *rest = args
    P, M1, M2 = T.shape

    def index(M, side):
        """the old edge each new edge copies, and which new edges are
        dead"""
        if case == 'odd_m2':
            mapping = list(range(M)) + [-1] * (1 if side == 1 else 3)
        elif case == 'dead_between':
            gap = 3 if side == 1 else 4
            mapping = [-1] if side == 1 else []
            for e in range(M):
                if e % gap == gap - 1:
                    mapping.append(-1)
                mapping.append(e)
        else:
            raise ValueError(f'no edge case {case!r}')
        near, idx = 0, []
        for m in mapping:
            near = m if m >= 0 else near
            idx.append(near)
        return (torch.tensor(idx, device=T.device),
                torch.tensor([m < 0 for m in mapping], device=T.device))

    i1, dead1 = index(M1, 1)
    i2, dead2 = index(M2, 2)
    Tn = T.index_select(1, i1).index_select(2, i2)
    Tn[:, dead1, :] = 0
    Tn[:, :, dead2] = 0
    return [Tn.contiguous(), *(e.index_select(1, i).contiguous() for e, i in
                               ((esrc1, i1), (edst1, i1), (esrc2, i2),
                                (edst2, i2))), *rest]


def stream_plan_kind(plan):
    """The kind of a plan of ``ops.pcg.stream_plan``: ``'shared'`` (whole
    rows, side 2's list in shared memory), ``'list_in_device'`` (whole
    rows, the list in device memory), ``'chunked'`` (a row cut into
    chunks, z, p and the list in shared memory),
    ``'chunked_list_in_device'`` (chunks, the list in device memory) or
    ``'chunked_l2'`` (chunks, z, p and the list read from device
    memory)."""
    if not plan['chunk_cols']:
        return 'shared' if plan['list_in_smem'] else 'list_in_device'
    if not plan['vectors_in_smem']:
        return 'chunked_l2'
    return 'chunked' if plan['list_in_smem'] else 'chunked_list_in_device'


def stream_limit_for(M1, M2, N1, N2, device, kind, span=None, chunks=3):
    """The largest shared-memory limit, in bytes and 1 KiB steps below
    what a block can opt into, under which ``pcg_stream``'s plan for pairs
    of these shapes on the CUDA ``device`` is of ``kind``
    (:func:`stream_plan_kind`); for the chunked kinds, with a live span of
    ``span`` columns (default M2) cut into at least ``chunks`` chunks. Set
    it as ``pcg_stream.smem_limit`` to run that plan on these pairs."""
    from .ops import pcg
    span = M2 if span is None else span
    old = pcg.pcg_stream.smem_limit
    try:
        pcg.pcg_stream.smem_limit = None
        limit = pcg._stream_smem_limit(device)
        while limit >= 1024:
            pcg.pcg_stream.smem_limit = limit
            try:
                plan = pcg.stream_plan(M1, M2, N1, N2, device)
            except ValueError:
                break
            if stream_plan_kind(plan) == kind and (
                    not plan['chunk_cols']
                    or -(-span // plan['chunk_cols']) >= chunks):
                return limit
            limit -= 1024
    finally:
        pcg.pcg_stream.smem_limit = old
    raise ValueError(f'no shared-memory limit gives a {kind!r} plan for '
                     f'M1={M1}, M2={M2}, N1={N1}, N2={N2}')
