"""Composite (multi-feature) microkernel; counterpart of
``graphdot_tpu/microkernel/composite.py``, whose ``apply`` works on torch
tensors unchanged."""
from collections.abc import Mapping

import numpy as np

from ..util.pretty_tuple import pretty_tuple
from ._base import MicroKernel

_REDUCTIONS = {
    '+': ('Additive', np.add),
    '*': ('Product', np.multiply),
}


def Composite(oper, **kw_kernels):
    r"""Combines microkernels on individual features with a reduction
    operator: :math:`k_\mathrm{composite}(X, Y; \mathrm{op}) =
    k_{a_1}(X_{a_1}, Y_{a_1})\,\mathrm{op}\,k_{a_2}(X_{a_2}, Y_{a_2})
    \ldots`

    Parameters
    ----------
    oper: str
        '+' or '*' (limited by positive-definiteness requirements).
    kw_kernels: dict of attribute=kernel pairs
    """
    if oper not in _REDUCTIONS:
        raise ValueError(f'Invalid reduction operator {repr(oper)}.')

    class CompositeKernel(MicroKernel):

        name = property(lambda self: 'Composite')
        opname = property(lambda self: _REDUCTIONS[self.opstr][0])

        def __init__(self, opstr, **kw_kernels):
            self.opstr = opstr
            self.ufunc = _REDUCTIONS[opstr][1]
            self.kw_kernels = kw_kernels

        def __repr__(self):
            parts = [repr(self.opstr)] + [
                f'{key}={child!r}'
                for key, child in self.kw_kernels.items()
            ]
            return f"{self.name}({', '.join(parts)})"

        def __call__(self, X, Y, jac=False):
            values = []
            jacobians = []
            for key, child in self.kw_kernels.items():
                if jac:
                    f, dfs = child(X[key], Y[key], True)
                    jacobians.append((f, dfs))
                else:
                    f = child(X[key], Y[key])
                values.append(f)
            total = self.ufunc.reduce(values)
            if not jac:
                return total
            # product rule: each child's jacobian scales by the product
            # of the remaining factors (identity for '+')
            chain = []
            for f, dfs in jacobians:
                factor = total / f if self.opstr == '*' else 1.0
                chain.extend(factor * df for df in dfs)
            return total, np.asarray(chain)

        @property
        def n_theta(self):
            return sum(k.n_theta for k in self.kw_kernels.values())

        def apply(self, theta, X, Y):
            out = None
            offset = 0
            for key, child in self.kw_kernels.items():
                t = theta[offset:offset + child.n_theta]
                offset += child.n_theta
                piece = child.apply(t, X[key], Y[key])
                out = piece if out is None else (
                    out + piece if self.opstr == '+' else out * piece)
            return out

        def c_expr(self, theta, X, Y):
            if not (isinstance(X, Mapping) and isinstance(Y, Mapping)):
                return None
            parts, offset = [], 0
            for key, child in self.kw_kernels.items():
                t = theta[offset:offset + child.n_theta]
                offset += child.n_theta
                piece = (child.c_expr(t, X[key], Y[key])
                         if key in X and key in Y else None)
                if piece is None:
                    return None
                parts.append(piece)
            return f'({f" {self.opstr} ".join(parts)})'

        def _gather(self, attr):
            return pretty_tuple(self.name, self.kw_kernels.keys())(
                *[getattr(k, attr) for k in self.kw_kernels.values()])

        theta = property(lambda self: self._gather('theta'))

        @theta.setter
        def theta(self, seq):
            for child, value in zip(self.kw_kernels.values(), seq):
                child.theta = value

        bounds = property(lambda self: self._gather('bounds'))

        @property
        def minmax(self):
            spans = [k.minmax for k in self.kw_kernels.values()]
            return tuple(self.ufunc.reduce(spans, axis=0))

    for key in kw_kernels:
        setattr(CompositeKernel, key,
                property(lambda self, key=key: self.kw_kernels[key]))

    return CompositeKernel(oper, **kw_kernels)
