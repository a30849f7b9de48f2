"""Sequence rewriters for tree search (reference:
``graphdot/model/tree_search/_rewriter.py:29-215``); a copy of
``graphdot_tpu/model/tree_search/_rewriter.py``.

The n-gram context model is re-implemented as a substring Counter
flattened into a nested-dict trie, instead of the reference's
``treelib``-based incremental pointer walk.
"""
from abc import ABC, abstractmethod
from collections import Counter

import numpy as np

from ...util.random import as_generator


class AbstractRewriter(ABC):
    """Abstract base class for graph rewrite rules."""

    @abstractmethod
    def __call__(self, g):
        """Rewrite the given graph using a rule drawn randomly from a pool;
        returns a list of new graphs."""


class _ContextModel:
    """Distributions of the symbol following every k-gram (k <= n) of a
    training corpus, stored as a dict mapping context tuples to
    (symbols, frequencies)."""

    def __init__(self, corpus, n):
        counts = Counter()
        for seq in corpus:
            sym = list(seq)
            for stop in range(1, len(sym) + 1):
                for start in range(max(stop - n - 1, 0), stop):
                    counts[tuple(sym[start:stop])] += 1
        table = {}
        for gram, c in counts.items():
            table.setdefault(gram[:-1], []).append((gram[-1], c))
        self.n = n
        self.follow = {
            cxt: (
                [s for s, _ in pairs],
                np.array([c for _, c in pairs], dtype=float)
                / sum(c for _, c in pairs),
            )
            for cxt, pairs in table.items()
        }

    def continuation(self, s, k):
        """Symbols and frequencies following the longest k-gram (k <= n)
        of ``s`` that ends right before position ``k`` and has a known
        continuation; falls back to the unconditional distribution."""
        for length in range(min(self.n, k), -1, -1):
            hit = self.follow.get(tuple(s[k - length:k]))
            if hit is not None:
                return hit
        return self.follow[()]


class LookAheadSequenceRewriter(AbstractRewriter):
    """A sequence rewriter performing contextual insert/mutate/delete edits
    where inserted/mutated symbols are drawn from the distribution of
    symbols following the longest matching k-gram (k <= n) of the training
    set.

    Parameters
    ----------
    n: int
        Maximum look-behind context length.
    b: int
        Branching factor — number of offspring per input sequence.
    min_edits, max_edits: int
        Minimum/maximum number of edits per offspring.
    p_insert, p_mutate, p_delete: numbers
        Relative frequencies of the three operations.
    random_state: np.random.Generator or int
    """

    def __init__(self, n=1, b=3, min_edits=1, max_edits=5, p_insert=1,
                 p_mutate=1, p_delete=1, random_state=None):
        self.n = n
        self.b = b
        self.p_imd = np.array(
            [p_insert, p_mutate, p_delete], dtype=float
        )
        self.p_imd /= self.p_imd.sum()
        self.min_edits = min_edits
        self.max_edits = max_edits
        self.rng = as_generator(random_state)

    @property
    def tree(self):
        """The fitted context model (kept under the reference's
        attribute name)."""
        try:
            return self._model
        except AttributeError:
            raise RuntimeError(
                'The rewriter must be trained on a collection of sequences '
                'first using the ``fit()`` method.'
            )

    def fit(self, X):
        """Learn the n-gram distribution from the given sequences."""
        self._model = _ContextModel(X, self.n)
        return self

    def _propose(self, s, k):
        symbols, freq = self.tree.continuation(s, k)
        return symbols[self.rng.choice(len(symbols), p=freq)]

    def _edit(self, s, k, op):
        """One edit at position k: 0 = insert, 1 = mutate, 2 = delete."""
        patch = type(s)() if op == 2 else type(s)(self._propose(s, k))
        return s[:k] + patch + s[k + (op != 0):]

    def _rewrite(self, s):
        """Apply one random insert/mutate/delete edit to the sequence."""
        if len(s) == 0:
            # insertion is the only valid edit on an empty sequence
            # (the reference raises from ``rng.choice(0)`` here,
            # ``graphdot/model/tree_search/_rewriter.py:190``)
            return self._edit(s, 0, 0)
        return self._edit(
            s, self.rng.choice(len(s)), self.rng.choice(3, p=self.p_imd)
        )

    def __call__(self, s):
        """Generate up to ``b`` unique offspring sequences, each rewritten
        between min_edits and max_edits times."""
        offspring = set()
        for _ in range(self.b):
            t = s
            for i in range(self.max_edits):
                t = self._rewrite(t)
                if (
                    i + 1 >= self.min_edits
                    and t != s and t not in offspring
                ):
                    offspring.add(t)
                    break
        return list(offspring)
