"""Search-tree container: a column frame of node records with parent and
children links (fills the role of the reference's
``graphdot/model/tree_search/_tree.py:6``); a copy of
``graphdot_tpu/model/tree_search/_tree.py``."""
from ...graph.frame import DataFrame


class Tree(DataFrame):
    """A dataframe whose rows are search-tree nodes; the 'children' column
    holds nested Trees and 'parent' holds NodeView back-references."""

    class NodeView:
        """Mutable row proxy: attribute access reads/writes tree columns."""

        __slots__ = ('tree', 'i')

        def __init__(self, tree, i):
            object.__setattr__(self, 'tree', tree)
            object.__setattr__(self, 'i', i)

        def __getattr__(self, key):
            if key.startswith('__'):
                # numpy and pickle probe dunder attributes on arbitrary
                # objects; never forward those to tree columns
                raise AttributeError(key)
            return self.tree[key][self.i]

        def __setattr__(self, key, val):
            self.tree[key][self.i] = val

        def __str__(self):
            row = self.tree
            return ' '.join(
                f'{c}:{row[c][self.i]}' for c in row.columns
            )

    def __init__(self, data={}, **kwargs):
        merged = dict(data)
        merged.update(kwargs)
        super().__init__(merged)

    def iternodes(self):
        """Yield a NodeView per row."""
        return map(Tree.NodeView, [self] * len(self), range(len(self)))

    @property
    def flat(self):
        """Depth-first flattening into a plain DataFrame with a 'level'
        column (parent/children links dropped), via an explicit stack."""
        payload = [
            c for c in self.columns if c not in ('parent', 'children')
        ]
        rows = []
        stack = [(self, 0, 0)]  # (subtree, row cursor, level)
        while stack:
            tree, at, level = stack.pop()
            while at < len(tree):
                rows.append(
                    (level,) + tuple(tree[c][at] for c in payload)
                )
                sub = tree.children[at]
                at += 1
                if sub is not None:
                    stack.append((tree, at, level))
                    tree, at, level = sub, 0, level + 1
        return DataFrame(dict(zip(['level'] + payload, zip(*rows))))

    def __str__(self):
        return '\n'.join(
            '  ' * node.level + str(node)
            for node in self.flat.itertuples('node')
        )
