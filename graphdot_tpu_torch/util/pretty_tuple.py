"""Named-tuple factory with a pretty tree-style repr.

API parity with the reference ``graphdot/util/pretty_tuple.py:7`` — used to
expose hierarchical hyperparameter trees such as ``kernel.theta``.
"""
import functools
from collections import namedtuple


def pretty_tuple(name, fields):
    """Create a namedtuple subclass with a hierarchical repr.

    The class is cached per (name, fields): hot host-side paths (e.g.
    the dense test oracle evaluating a sympy microkernel per product-
    graph entry) read ``kernel.theta`` per call, and creating a fresh
    namedtuple class each time dominated their runtime."""
    return _pretty_tuple_cls(name, tuple(fields))


@functools.lru_cache(maxsize=None)
def _pretty_tuple_cls(name, fields):

    class PrettyTuple(namedtuple(name, fields)):

        def __repr__(self):
            return '\n'.join(self._repr_lines())

        def _repr_lines(self, prefix=''):
            lines = [name]
            n = len(self._fields)
            for i, (field, value) in enumerate(zip(self._fields, self)):
                last = i == n - 1
                branch = '└── ' if last else '├── '
                cont = '    ' if last else '│   '
                if hasattr(value, '_repr_lines'):
                    sub = value._repr_lines()
                    lines.append(f'{branch}{field}: {sub[0]}')
                    lines.extend(cont + s for s in sub[1:])
                else:
                    lines.append(f'{branch}{field}: {value!r}')
            return lines

    PrettyTuple.__name__ = name
    return PrettyTuple
