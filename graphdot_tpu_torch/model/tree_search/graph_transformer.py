"""Monte Carlo tree search over graph rewrites (fills the role of the
reference's ``graphdot/model/tree_search/graph_transformer.py:9``); a copy
of ``graphdot_tpu/model/tree_search/graph_transformer.py``. The surrogate is
any model with ``predict(X, return_cov=True)``, the port's
``GaussianProcessRegressor`` on the card among them.

Search loop per iteration: descend by maximal score (a Gaussian
target-likelihood plus a UCB exploration bonus), expand the reached leaf
with the rewriter, score the offspring with a GP surrogate, then propagate
inverse-variance-weighted means/stds back to the root.
"""
import numpy as np
from scipy.stats import norm

from ...util.random import as_generator
from ._tree import Tree


class MCTSGraphTransformer:
    """MCTS-based optimization / root finding in a space of graphs.

    Parameters
    ----------
    rewriter: callable (node, rng) -> list of graphs
        Proposes rewritten offspring of a node's graph.
    surrogate: object
        Property predictor exposing ``predict(X, return_cov=True)``.
    exploration_bias: float
        Weight of the UCB exploration term.
    precision: float
        Floor on predictive stds when scoring against the target.
    """

    def __init__(self, rewriter, surrogate, exploration_bias=1.0,
                 precision=0.01):
        self.rewriter = rewriter
        self.surrogate = surrogate
        self.exploration_bias = exploration_bias
        self.precision = precision

    def seek(self, g0, target, maxiter=500, return_tree=False,
             random_state=None):
        """Search for graphs whose predicted property approaches
        ``target``, starting from ``g0``. Returns the search tree, or a
        likelihood-sorted flat dataframe."""
        rng = as_generator(random_state)
        root = self._spawn(None, [g0])
        self._evaluate(root)
        for _ in range(maxiter):
            self._step(root, target, rng)
        if return_tree:
            return root
        flat = root.flat
        flat['likelihood'] = self._likelihood(target, flat)
        return flat.to_pandas().sort_values(
            ['likelihood'], ascending=False
        )

    # -- tree plumbing --------------------------------------------------

    def _spawn(self, parent, graphs):
        count = len(graphs)
        return Tree(
            parent=[parent] * count,
            children=[None] * count,
            g=graphs,
            visits=np.zeros(count, dtype=int),
        )

    def _evaluate(self, nodes):
        """Score fresh nodes with the surrogate's posterior."""
        mean, cov = self.surrogate.predict(nodes.g, return_cov=True)
        std = np.sqrt(cov.diagonal())
        for column, stat in (
            ('self_mean', mean), ('tree_mean', mean),
            ('self_std', std), ('tree_std', std),
            ('score', np.zeros_like(mean)),
        ):
            nodes[column] = stat.copy()
        nodes.visits += 1

    # -- scoring ---------------------------------------------------------

    def _likelihood(self, target, nodes):
        return norm.pdf(
            target, nodes.tree_mean,
            np.maximum(nodes.tree_std, self.precision)
        )

    def _ucb(self, target, nodes):
        bonus = self.exploration_bias * np.sqrt(
            np.log(nodes.parent[0].visits) / nodes.visits
        )
        return self._likelihood(target, nodes) + bonus

    # -- one MCTS iteration ----------------------------------------------

    def _descend(self, root):
        """Walk down the max-score child; bumps visit counters."""
        node = next(root.iternodes())
        node.visits += 1
        while node.children is not None:
            node = max(node.children.iternodes(),
                       key=lambda child: child.score)
            node.visits += 1
        return node

    def _step(self, root, target, rng):
        # selection, then expansion + simulation at the reached leaf
        node = self._descend(root)
        node.children = self._spawn(node, self.rewriter(node, rng))
        self._evaluate(node.children)

        # back-propagation of precision-weighted statistics
        up = node
        while up:
            stats = up.children
            w = stats.tree_std ** -2
            mean = np.average(stats.tree_mean, weights=w)
            var = np.average((stats.tree_mean - mean) ** 2, weights=w)
            up.tree_mean = mean
            up.tree_std = np.sqrt(var)
            stats['score'] = self._ucb(target, stats)
            up = up.parent
