"""MNOM partition-based reordering (pure Python/scipy); a copy of
``graphdot_tpu/graph/reorder/mnom.py``.

Reimplements the reference's PBR algorithm
(``graphdot/graph/reorder/pbr/mnom.py:11,187,296``) without its KaHyPar
dependency: the adjacency matrix's column-net hypergraph (one net per
column, pins = rows with nonzeros in it, diagonals enforced) is
recursively bisected into tile-sized parts with *exact* target part
weights (multiples of the tile size, so parts map 1:1 onto tiles), and —
the MNOM idea — each bisection adds high-cost *message nets* that tie
together the rows of the current subset touched by any already-formed
part, steering the cut toward minimizing the number of nonempty
tile x tile blocks.

Where the reference calls KaHyPar for each 2-way cut, this module uses a
Fiedler-vector seeded split refined by strict-balance Kernighan-Lin
swaps on the weighted hyperedge-cut objective — dependency-free and
fast enough for the few-hundred-node graphs the solver batches.
"""
import numpy as np
import scipy.sparse
import scipy.sparse.csgraph


def _column_nets(A):
    """pins[j] = sorted row indices of nonzeros in column j, plus the
    diagonal (enforced, as in the reference ColnetHygr)."""
    A = scipy.sparse.csc_matrix(A)
    n = A.shape[0]
    nets = []
    for j in range(n):
        rows = A.indices[A.indptr[j]:A.indptr[j + 1]]
        nets.append(np.unique(np.append(rows, j)))
    return nets


def _fiedler_order(A_sub):
    # dense eigh: the shift-free sparse 'SM' eigensolver fails to
    # converge routinely at these sizes, and the subsets are small
    # (<= a few thousand rows) so the dense path is both robust and fast
    n = A_sub.shape[0]
    if n <= 2:
        return np.arange(n)
    L = scipy.sparse.csgraph.laplacian(A_sub.astype(float))
    vals, vecs = np.linalg.eigh(np.asarray(L.todense()))
    return np.argsort(vecs[:, np.argsort(vals)[1]])


def _cut(side, nets, weights):
    """Weighted hyperedge cut of a 0/1 side assignment."""
    total = 0
    for pins, w in zip(nets, weights):
        s = side[pins]
        if s.min() != s.max():
            total += w
    return total


def _kl_refine(side, nets, weights, max_passes=4):
    """Strict-balance Kernighan-Lin refinement: repeatedly swap the
    (left, right) vertex pair with the best exact cut improvement."""
    n = len(side)
    # vertex -> incident net ids
    incident = [[] for _ in range(n)]
    for e, pins in enumerate(nets):
        for v in pins:
            incident[v].append(e)

    def move_gain(v):
        """Cut change of flipping v alone (negative = improvement)."""
        delta = 0
        for e in incident[v]:
            pins = nets[e]
            same = 0
            other = 0
            for u in pins:
                if u == v:
                    continue
                if side[u] == side[v]:
                    same += 1
                else:
                    other += 1
            before_cut = (other > 0)
            after_cut = (same > 0)
            delta += weights[e] * (after_cut - before_cut)
        return delta

    for _ in range(max_passes):
        improved = False
        for _ in range(n):
            gains = np.array([move_gain(v) for v in range(n)])
            left = np.where(side == 0)[0]
            right = np.where(side == 1)[0]
            if not len(left) or not len(right):
                return side
            vl = left[np.argmin(gains[left])]
            vr = right[np.argmin(gains[right])]
            base = _cut(side, nets, weights)
            side[vl], side[vr] = 1, 0
            if _cut(side, nets, weights) < base:
                improved = True
            else:
                side[vl], side[vr] = 0, 1
                break
        if not improved:
            break
    return side


class PbrMnom:
    """Partitioning-based reordering minimizing nonempty tiles.

    Same constructor surface as the reference (tilesize, mnc,
    addMsgNets), minus the KaHyPar config.
    """

    def __init__(self, tilesize=8, mnc=100, addMsgNets=True,
                 refine_passes=4):
        self.tilesize = tilesize
        self.mnc = mnc
        self.addMsgNets = addMsgNets
        self.refine_passes = refine_passes

    def _target_left(self, n_sub, k):
        """Exact left-block weight for splitting k tile-parts, matching
        the reference's target policy (mnom.py:232-246)."""
        t = self.tilesize
        if n_sub % t != 0:
            return ((k + 1) // 2) * t
        if k % 2 == 0:
            return (k // 2) * t
        return (k // 2 + 1) * t

    def _bisect(self, A, nets, verts, k, gpvec, next_part):
        """Split ``verts`` into tile-aligned halves; returns
        (left_verts, right_verts, k_left, k_right)."""
        t = self.tilesize
        n_sub = len(verts)
        tgt_l = min(self._target_left(n_sub, k), n_sub)

        # sub-nets: original column nets restricted to the subset
        local = -np.ones(A.shape[0], dtype=np.int64)
        local[verts] = np.arange(n_sub)
        sub_nets, sub_w = [], []
        for j in verts:
            pins = local[nets[j]]
            pins = pins[pins >= 0]
            if len(pins) > 1:
                sub_nets.append(pins)
                sub_w.append(10)

        # message nets: rows of the subset touched by each other part
        if self.addMsgNets and gpvec.max() >= 0:
            touch = {}
            for v in verts:
                for u in nets[v]:
                    p = gpvec[u]
                    if p >= 0:
                        touch.setdefault(p, set()).add(local[v])
            for pins in touch.values():
                if len(pins) > 1:
                    sub_nets.append(np.fromiter(pins, dtype=np.int64))
                    sub_w.append(2 * self.mnc * 10)

        # Fiedler seed at the exact target weight + strict-balance KL
        order = _fiedler_order(A[np.ix_(verts, verts)])
        side = np.ones(n_sub, dtype=np.int8)
        side[order[:tgt_l]] = 0
        if sub_nets:
            side = _kl_refine(side, sub_nets, sub_w,
                              max_passes=self.refine_passes)

        left = verts[side == 0]
        right = verts[side == 1]
        k_r = k // 2
        k_l = k_r + (k % 2)
        if self._target_left(n_sub, k) != len(left):
            # KL keeps balance exact; this only fires for degenerate
            # subsets smaller than one tile
            k_l = max(1, int(np.ceil(len(left) / t)))
            k_r = max(1, int(np.ceil(len(right) / t)))
        return left, right, k_l, k_r

    def __call__(self, row_ids, col_ids, nrow, ncol):
        """Reorder a symmetric sparse matrix; returns the permutation."""
        n = nrow
        t = self.tilesize
        if n <= t:
            return np.arange(n)
        A = scipy.sparse.coo_matrix(
            (np.ones(len(row_ids)), (row_ids, col_ids)), shape=(n, n)
        ).tocsr()
        A = ((A + A.T) > 0).astype(np.int8)
        nets = _column_nets(A)

        gpvec = -np.ones(n, dtype=np.int64)    # -1 = not yet assigned
        parts = []                             # finished tile parts

        queue = [(np.arange(n), int(np.ceil(n / t)))]
        while queue:
            verts, k = queue.pop(0)
            if k <= 1 or len(verts) <= t:
                gpvec[verts] = len(parts)
                parts.append(verts)
                continue
            left, right, k_l, k_r = self._bisect(
                A, nets, verts, k, gpvec, len(parts)
            )
            queue.append((left, k_l))
            queue.append((right, k_r))

        order = np.concatenate(parts)
        return np.asarray(order, dtype=np.int64)
