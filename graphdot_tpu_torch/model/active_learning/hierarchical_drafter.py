"""Hierarchical representative-sample selection; a copy of
``graphdot_tpu/model/active_learning/hierarchical_drafter.py`` (numpy
only).

Selecting n representatives from a large set with an O(N^2)-or-worse
selector is made tractable by k-way divide and conquer: each branch
forwards an oversampled shortlist (a*n/k candidates) so the parent
selector always has headroom to correct branch-local choices. The
tree is evaluated here with an explicit post-order worklist rather
than recursion, so arbitrarily deep hierarchies cannot hit Python's
recursion limit.
"""
import numpy as np


def _as_rng(random_state):
    if isinstance(random_state, np.random.Generator):
        return random_state
    if random_state is not None:
        return np.random.Generator(np.random.PCG64(random_state))
    return np.random.default_rng()


class HierarchicalDrafter:
    """Divide-and-conquer wrapper around an expensive subset selector.

    Parameters
    ----------
    selector: callable(X, n) -> indices
        The leaf-level selection algorithm (e.g. VarianceMinimizer).
    k: int > 1
        Branching factor.
    a: float in (1, k]
        Oversampling multiplier per level.
    leaf_ratio: float in (0, 1) or 'auto'
        When output/input exceeds this ratio, select directly instead of
        dividing further.
    """

    def __init__(self, selector, k=2, a=2, leaf_ratio='auto'):
        if k <= 1:
            raise ValueError('k must be an integer greater than 1')
        if not callable(selector):
            raise TypeError('selector must be callable')
        self.selector = selector
        self.k = k
        self.a = a
        self.leaf_ratio = 0.5 if leaf_ratio == 'auto' else leaf_ratio

    def _is_leaf(self, pool_size, n):
        return (
            pool_size <= n
            or n / pool_size >= self.leaf_ratio
            or n <= self.k / self.a
        )

    def __call__(self, X, n, random_state=None, verbose=False):
        """Pick a sorted array of n sample indices from X."""
        if len(X) < n:
            raise ValueError(f'Cannot choose {n} out of {len(X)} samples.')
        if not isinstance(X, np.ndarray):
            X = np.asarray(X, dtype=object)
        pool = _as_rng(random_state).permutation(len(X))

        # Post-order evaluation over the implicit k-ary slice tree.
        # 'expand' frames either resolve a leaf into its output slot or
        # push a 'join' frame plus k child 'expand' frames; 'join'
        # frames (which surface only after all their children resolved)
        # run the selector on the concatenated shortlists.
        root = [None]
        stack = [('expand', pool, int(n), 0, root, 0)]
        while stack:
            tag, pool, quota, depth, out, slot = stack.pop()
            if tag == 'join':
                # all child cells are filled by now (children sit above
                # their join frame on the LIFO stack)
                pool = np.concatenate([cell[0] for cell in pool])
            elif verbose:
                print(' ' * depth + f'C_{len(pool)}_{quota}',
                      quota / len(pool), self.leaf_ratio)
            if len(pool) <= quota:
                out[slot] = pool
            elif tag == 'join' or self._is_leaf(len(pool), quota):
                out[slot] = pool[self.selector(X[pool], quota)]
            else:
                cells = [[None] for _ in range(self.k)]
                carry = int(quota * self.a // self.k)
                cuts = np.linspace(0, len(pool), self.k + 1, dtype=int)
                stack.append(('join', cells, quota, depth, out, slot))
                for cell, lo, hi in zip(cells, cuts[:-1], cuts[1:]):
                    stack.append(('expand', pool[lo:hi], carry,
                                  depth + 1, cell, 0))
        return np.sort(root[0])
