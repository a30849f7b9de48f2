"""Marginalized MiniMax (M3) metric between molecules; counterpart of
``graphdot_tpu/experimental/metric/m3.py``.

The distance of two molecules is the maximin of the nodal distances
sqrt(2 - 2 K) over the ``Graph.from_ase`` graphs, with K the normalized
nodal similarity of the marginalized graph kernel.

Where the port differs from the JAX module: ``__call__`` solves the
product graphs with the port's :class:`MarginalizedGraphKernel` on
``device`` (the card unless the caller asks for the CPU), all three
pairs of the two graphs in one call. ``_mlgk``, the JAX module's pure-SciPy
sparse-CG solve, is kept as the host oracle it is held against, and
:meth:`_maximin` reduces either's similarities to the distance.
"""
import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from ...graph import Graph
from ...graph.adjacency.atomic import AtomicAdjacency
from ...kernel.marginalized import MarginalizedGraphKernel
from ...microkernel import KroneckerDelta, SquareExponential, TensorProduct


class M3:
    """The Marginalized MiniMax (M3) metric between molecules.

    ``device``: torch device of the kernel's solves; the card
    (``'cuda'``) unless the caller asks for ``'cpu'``, and without a
    usable card a CUDA device raises."""

    def __init__(self, use_charge=False, adjacency='default', q=0.01,
                 element_delta=0.2, bond_eps=0.02, charge_eps=0.2,
                 device='cuda'):
        self.use_charge = use_charge
        if adjacency == 'default':
            self.adjacency = AtomicAdjacency(shape='tent2', zoom=0.75)
        else:
            self.adjacency = adjacency
        self.q = q
        if use_charge:
            self.node_kernel = TensorProduct(
                element=KroneckerDelta(element_delta),
                charge=SquareExponential(charge_eps),
            )
        else:
            self.node_kernel = TensorProduct(
                element=KroneckerDelta(element_delta)
            )
        self.edge_kernel = TensorProduct(
            length=SquareExponential(bond_eps)
        )
        self.kernel = MarginalizedGraphKernel(
            self.node_kernel, self.edge_kernel, q=q, device=device)

    def _graphs(self, atoms1, atoms2):
        """The two molecules' graphs, as the metric builds them."""
        args = dict(use_charge=self.use_charge, adjacency=self.adjacency)
        return Graph.from_ase(atoms1, **args), Graph.from_ase(atoms2, **args)

    def __call__(self, atoms1, atoms2):
        g1, g2 = self._graphs(atoms1, atoms2)
        R = self.kernel([g1, g2], nodal=True)
        n1 = len(g1.nodes)
        r = np.diagonal(R)
        return self._maximin(r[:n1], R[:n1, n1:], r[n1:])

    @staticmethod
    def _maximin(r1, R12, r2):
        """The distance from the nodal self similarities r1, r2 and the
        cross similarities R12 of the two graphs."""
        K = r1[:, None] ** -0.5 * R12 * r2[None, :] ** -0.5
        D = np.sqrt(np.maximum(2 - 2 * K, 0))
        return max(D.min(axis=1).max(), D.min(axis=0).max())

    def _mlgk(self, g1, g2):
        n1, n2 = len(g1.nodes), len(g2.nodes)

        def sym_adj(g, n):
            A = scipy.sparse.csc_matrix(
                (g.edges['!w'], (g.edges['!i'], g.edges['!j'])), (n, n)
            )
            return A + A.T

        A1, A2 = sym_adj(g1, n1), sym_adj(g2, n2)
        d1 = np.asarray(A1.sum(axis=0)).ravel()
        d2 = np.asarray(A2.sum(axis=0)).ravel()
        Ax = scipy.sparse.kron(A1, A2)

        Vx = np.array([
            self.node_kernel(a1, a2)
            for a1 in g1.nodes.itertuples()
            for a2 in g2.nodes.itertuples()
        ])

        # product-edge couplings, vectorized: evaluate the edge kernel on
        # the m1 x m2 cross of undirected edges once, then scatter each
        # value to the four orientation combinations on the product space
        m1, m2 = len(g1.edges), len(g2.edges)
        kvals = np.array([
            self.edge_kernel(e1, e2)
            for e1 in g1.edges.itertuples()
            for e2 in g2.edges.itertuples()
        ]).reshape(m1, m2)
        i1 = np.asarray(g1.edges['!i'], dtype=np.int64)
        j1 = np.asarray(g1.edges['!j'], dtype=np.int64)
        i2 = np.asarray(g2.edges['!i'], dtype=np.int64)
        j2 = np.asarray(g2.edges['!j'], dtype=np.int64)
        ends1 = np.stack([i1, j1])                      # [2, m1]
        ends2 = np.stack([i2, j2])                      # [2, m2]
        rows, cols, vals = [], [], []
        for o1 in (0, 1):                # orientation of the g1 edge
            for o2 in (0, 1):            # orientation of the g2 edge
                src = (ends1[o1][:, None] * n2
                       + ends2[o2][None, :])
                dst = (ends1[1 - o1][:, None] * n2
                       + ends2[1 - o2][None, :])
                rows.append(src.ravel())
                cols.append(dst.ravel())
                vals.append(kvals.ravel())
        Ex = scipy.sparse.csc_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            (n1 * n2, n1 * n2)
        )

        Dx = np.kron(d1, d2) / (1 - self.q) ** 2
        Y = scipy.sparse.diags([Dx / Vx], [0]) - Ax.multiply(Ex)
        R, _ = scipy.sparse.linalg.cg(
            Y, Dx,
            M=scipy.sparse.diags([Vx / Dx], [0]),
            atol=1e-7
        )
        return R.reshape(n1, n2)
