"""SymPy-expression microkernel factory.

Counterpart of ``graphdot_tpu/microkernel/_sympy.py``. The expression is
lambdified twice: once with numpy (host-side scalar ``__call__`` semantics,
including analytic jacobians) and once with a map of torch functions (the
tensor ``apply`` used by the solver). It is also printed as float32 CUDA C
(``c_expr``), for the edge coupling's one pass (``csrc/setup_edge.cu``).
"""
from collections import OrderedDict

import numpy as np
import sympy as sy
import torch
from sympy.codegen.ast import float32, real
from sympy.printing.c import C99CodePrinter
from sympy.utilities.lambdify import lambdify

from ..util.pretty_tuple import pretty_tuple
from ._base import MicroKernel, _column

#: sympy function name -> torch function; lambdify prints every name in a
#: dict module as a bare call, so the generated code calls these
_TORCH_MODULE = [{
    'sqrt': torch.sqrt, 'exp': torch.exp, 'log': torch.log,
    'sin': torch.sin, 'cos': torch.cos, 'tan': torch.tan,
    'sinh': torch.sinh, 'cosh': torch.cosh, 'tanh': torch.tanh,
    'Abs': torch.abs, 'Pow': torch.pow, 'pi': np.pi,
    'Max': torch.maximum, 'Min': torch.minimum,
}]


class _Printer(C99CodePrinter):
    """sympy's C99 printer in float32: ``expf``, ``powf``, ``0.5F``; the
    integer powers that torch computes by products (2, 3, and -2 as a
    reciprocal) printed as products, and constants as float literals."""

    def __init__(self):
        super().__init__(settings={'type_aliases': {real: float32}})

    def _print_Pow(self, expr):
        e = expr.exp
        if e.is_Integer and int(e) in (2, 3, -2):
            prod = '*'.join([f'({self._print(expr.base)})'] * abs(int(e)))
            return f'({prod})' if e > 0 else f'(1.0F/({prod}))'
        return super()._print_Pow(expr)

    def _print_NumberSymbol(self, expr):
        return f'{float(torch.tensor(float(expr))):.9g}F'

    _print_Pi = _print_Exp1 = _print_NumberSymbol


def _c_function(expr, vars, hypers):
    """``expr`` as a C lambda of floats ``(u, v, h0, h1, ...)`` (the two
    features, then the hyperparameters), or None where the printer cannot
    print it."""
    u, v, *h = sy.symbols(f'u v h:{len(hypers)}')
    names = [*vars, *(sy.Symbol(str(s)) for s in hypers)]
    expr = expr.xreplace(dict(zip(names, [u, v, *h])))
    if not expr.free_symbols <= {u, v, *h}:
        return None
    printer = _Printer()
    body = printer.doprint(expr)
    if printer._not_supported:
        return None
    params = ', '.join(f'float {s}' for s in (u, v, *h))
    return f'[]({params}) {{ return {body}; }}'


def _from_sympy(name, desc, expr, vars, *hyperparameter_specs,
                minmax=(0, 1)):
    """Create a microkernel class from a SymPy expression. See
    :meth:`MicroKernel.from_sympy` for the specification format."""
    assert isinstance(name, str) and name.isidentifier()

    if isinstance(expr, str):
        expr = sy.sympify(expr)

    if len(vars) != 2:
        raise ValueError('A microkernel must have exactly two variables')
    vars = [sy.Symbol(v) if isinstance(v, str) else v for v in vars]

    hyperdefs = OrderedDict()
    for spec in hyperparameter_specs:
        if not hasattr(spec, '__iter__'):
            hyperdefs[spec] = dict(dtype=np.dtype(np.float32))
        elif len(spec) == 1:
            hyperdefs[spec[0]] = dict(dtype=np.dtype(np.float32))
        elif len(spec) == 2:
            symbol, dtype = spec
            hyperdefs[symbol] = dict(dtype=np.dtype(dtype))
        elif len(spec) == 3:
            symbol, dtype, doc = spec
            hyperdefs[symbol] = dict(dtype=np.dtype(dtype), doc=doc)
        elif len(spec) == 4:
            symbol, dtype, lb, ub = spec
            hyperdefs[symbol] = dict(dtype=np.dtype(dtype), bounds=(lb, ub))
        elif len(spec) == 5:
            symbol, dtype, lb, ub, doc = spec
            hyperdefs[symbol] = dict(
                dtype=np.dtype(dtype), bounds=(lb, ub), doc=doc
            )
        else:
            raise ValueError(
                'Invalid hyperparameter specification, must be one of '
                '(symbol), (symbol, dtype), (symbol, dtype, doc), '
                '(symbol, dtype, lb, ub), (symbol, dtype, lb, ub, doc)'
            )

    class uKernel(MicroKernel):

        _expr = expr
        _vars = vars
        _hyperdefs = hyperdefs

        @property
        def name(self):
            return name

        def __init__(self, *args, **kwargs):
            self._theta_values = values = OrderedDict()
            self._theta_bounds = bounds = OrderedDict()

            for symbol, value in zip(self._hyperdefs, args):
                values[symbol] = value

            for symbol in self._hyperdefs:
                try:
                    values[symbol] = kwargs[symbol]
                except KeyError:
                    if symbol not in values:
                        raise KeyError(
                            f'Hyperparameter {symbol} not provided '
                            f'for {self.name}'
                        )
                try:
                    bounds[symbol] = kwargs['%s_bounds' % symbol]
                except KeyError:
                    try:
                        bounds[symbol] = self._hyperdefs[symbol]['bounds']
                    except KeyError:
                        raise KeyError(
                            f'Bounds for hyperparameter {symbol} of '
                            f'microkernel {self.name} not set, and no '
                            'defaults were given.'
                        )
                self._assert_bounds(symbol, bounds[symbol])

        @property
        def _vars_and_hypers(self):
            if not hasattr(self, '_vars_and_hypers_cached'):
                self._vars_and_hypers_cached = [
                    *self._vars, *self._hyperdefs.keys()
                ]
            return self._vars_and_hypers_cached

        @property
        def _fun(self):
            cls = type(self)
            if not hasattr(cls, '_fun_cached'):
                cls._fun_cached = lambdify(self._vars_and_hypers, self._expr)
            return cls._fun_cached

        @property
        def _fun_torch(self):
            cls = type(self)
            if not hasattr(cls, '_fun_torch_cached'):
                cls._fun_torch_cached = lambdify(
                    self._vars_and_hypers, self._expr,
                    modules=_TORCH_MODULE
                )
            return cls._fun_torch_cached

        @property
        def _jac(self):
            cls = type(self)
            if not hasattr(cls, '_jac_cached'):
                cls._jac_cached = [
                    lambdify(self._vars_and_hypers, sy.diff(expr, h))
                    for h in self._hyperdefs
                ]
            return cls._jac_cached

        def __call__(self, x1, x2, jac=False):
            tv = tuple(self._theta_values.values())
            if jac is True:
                return (
                    self._fun(x1, x2, *tv),
                    np.array([j(x1, x2, *tv) for j in self._jac])
                )
            else:
                return self._fun(x1, x2, *tv)

        def __repr__(self):
            theta = ', '.join(
                f'{n}={v}' for n, v in self._theta_values.items()
            )
            bounds = ', '.join(
                f'{n}_bounds={v}' for n, v in self._theta_bounds.items()
            )
            return f'{self.name}({theta}, {bounds})'

        @property
        def n_theta(self):
            return len(self._hyperdefs)

        def apply(self, theta, X, Y):
            return self._fun_torch(
                X, Y, *[theta[i] for i in range(len(self._hyperdefs))]
            )

        def c_expr(self, theta, X, Y):
            cls = type(self)
            if not hasattr(cls, '_c_cached'):
                cls._c_cached = _c_function(
                    sy.sympify(self._expr), self._vars, list(self._hyperdefs))
            x, y = _column(X), _column(Y)
            if cls._c_cached is None or x is None or y is None:
                return None
            args = ', '.join([x, y, *theta[:self.n_theta]])
            return f'{cls._c_cached}({args})'

        @property
        def theta(self):
            return pretty_tuple(
                self.name, self._theta_values.keys()
            )(**self._theta_values)

        @theta.setter
        def theta(self, seq):
            assert len(seq) == len(self._theta_values)
            for theta, value in zip(self._hyperdefs, seq):
                self._theta_values[theta] = value

        @property
        def bounds(self):
            return tuple(self._theta_bounds.values())

        @property
        def minmax(self):
            return minmax

    param_docs = '\n'.join(
        f'{n}: {h["dtype"]}\n    {h.get("doc", "")}\n'
        f'{n}_bounds: tuple or "fixed"\n'
        f'    Optimization bounds of `{n}`, or "fixed".'
        for n, h in hyperdefs.items()
    )
    uKernel.__doc__ = f'{desc}\n\nParameters\n----------\n{param_docs}'
    uKernel.__name__ = name

    return uKernel
