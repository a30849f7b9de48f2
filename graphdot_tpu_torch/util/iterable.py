"""Tree-of-iterables helpers for hyperparameter flattening (fill the role
of the reference's ``graphdot/util/iterable.py``): the flat log-theta <->
hierarchical hyperparameter-tree round trip. A copy of
:mod:`graphdot_tpu.util.iterable` without ``replace`` and ``argmax``,
which the port does not use."""


def flatten(iterable):
    """Depth-first iteration through a tree of lists/tuples."""
    stack = [iter(iterable)]
    while stack:
        try:
            item = next(stack[-1])
        except StopIteration:
            stack.pop()
            continue
        if isinstance(item, (list, tuple)):
            stack.append(iter(item))
        else:
            yield item


def fold_like(flat, example):
    """Reshape a flat sequence into the tree structure of ``example``."""
    it = iter(flat)

    def build(template):
        out = []
        for node in template:
            if hasattr(node, '__iter__'):
                out.append(build(node))
            else:
                out.append(next(it))
        return tuple(out)

    return build(example)

