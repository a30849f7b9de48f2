"""Microkernel abstract base class and combinators, on torch tensors.

Counterpart of ``graphdot_tpu/microkernel/_base.py``. The host side (theta,
bounds, minmax and the scalar ``__call__`` with analytic jacobians) is the
same numpy code; ``apply(theta, X, Y)`` evaluates the kernel on tensors.

Feature pytrees at apply-time:

- scalar feature column -> tensor (broadcastable shape)
- variable-length feature column -> ``(values, mask)`` pair of tensors with
  a trailing padded axis
- multi-feature (Composite) input -> dict of column name -> feature
"""
from abc import ABC, abstractmethod
from collections.abc import Mapping

import operator
from itertools import starmap

import numpy as np
import torch

from ..util.iterable import flatten
from ..util.pretty_tuple import pretty_tuple


def _safe_div(num, den):
    """num / den where den > 0, else 0 — avoids NaNs from padded entries."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def _column(X):
    """The C expression of the one feature column an elementary kernel
    reads: ``X`` itself, or the value of a one-column mapping (as
    ``_solver._apply_on_features`` feeds such a kernel); None for several
    columns."""
    if isinstance(X, Mapping):
        return X[next(iter(X))] if len(X) == 1 else None
    return X


class MicroKernel(ABC):
    """The abstract base class for all microkernels."""

    @property
    @abstractmethod
    def name(self):
        """Name of the kernel."""

    @property
    def normalized(self):
        r"""A normalized version of the original kernel using the dot
        product formula: :math:`k^\mathrm{normalized}(i, j) =
        \frac{k(i, j)}{\sqrt{k(i, i) k(j, j)}}`."""
        return Normalize(self)

    @abstractmethod
    def __call__(self, i, j, jac=False):
        """Evaluate the kernel (and optionally its jacobian) on a single
        pair of features, host-side numpy semantics."""

    @abstractmethod
    def __repr__(self):
        pass

    @property
    @abstractmethod
    def n_theta(self):
        """Number of hyperparameters (including fixed ones)."""

    @abstractmethod
    def apply(self, theta, X, Y):
        """Vectorized evaluation on tensors.

        Parameters
        ----------
        theta: torch.Tensor
            1-D slice of ``n_theta`` linear-scale hyperparameters.
        X, Y: feature pytree
            Tensors (scalar features), (values, mask) pairs
            (variable-length features), or dicts thereof (multi-feature
            kernels). All leaf tensors must broadcast against each other.

        Returns
        -------
        torch.Tensor with the broadcast shape of the inputs.
        """

    def c_expr(self, theta, X, Y):
        """The kernel as a float32 CUDA C expression, the counterpart of
        :meth:`apply` for ``csrc/setup_edge.cu``: ``theta`` holds the C
        expressions of its ``n_theta`` hyperparameters, X and Y those of
        the features (a string for a scalar column, a mapping of them for
        several columns). None where the kernel has no such form, as on
        variable-length features; this default."""
        return None

    @property
    def flat_theta(self):
        """Linear-scale hyperparameters as a flat list."""
        return list(flatten(self.theta))

    @property
    @abstractmethod
    def theta(self):
        """A (possibly nested) named tuple of kernel hyperparameters."""

    @theta.setter
    @abstractmethod
    def theta(self, value):
        pass

    @property
    @abstractmethod
    def bounds(self):
        """Nested tuples of (lower, upper) bounds or 'fixed'."""

    @property
    @abstractmethod
    def minmax(self):
        """A 2-tuple of the minimum and maximum attainable values."""

    def _assert_bounds(self, hyp, bounds):
        if not ((isinstance(bounds, tuple) and len(bounds) == 2)
                or bounds == 'fixed'):
            raise ValueError(
                f'Bounds for hyperparameter {hyp} of kernel {self.name} '
                f'must be a 2-tuple or "fixed": {bounds} provided.'
            )

    @staticmethod
    def from_sympy(name, desc, expr, vars, *hyperparameter_specs,
                   minmax=(0, 1)):
        """Create a microkernel class from a SymPy expression; see
        :func:`graphdot_tpu_torch.microkernel._sympy._from_sympy`."""
        from ._sympy import _from_sympy
        return _from_sympy(
            name, desc, expr, vars, *hyperparameter_specs, minmax=minmax
        )

    def __add__(self, k):
        r"""``k1 + k2`` creates :math:`k_+(a, b) = k_1(a, b) + k_2(a, b)`"""
        return MicroKernelExpr.add(self, k)

    def __radd__(self, k):
        return MicroKernelExpr.add(k, self)

    def __mul__(self, k):
        r"""``k1 * k2`` creates
        :math:`k_\times(a, b) = k_1(a, b) k_2(a, b)`"""
        return MicroKernelExpr.mul(self, k)

    def __rmul__(self, k):
        return MicroKernelExpr.mul(k, self)

    def __pow__(self, c):
        r"""``k1**c`` creates :math:`k(a, b) = k_1(a, b)^c`"""
        return MicroKernelExpr.pow(self, c)


class MicroKernelExpr(MicroKernel):
    """Binary combinator node. Every operator is one concrete subclass
    parameterized by the scalar operation ``_op`` and its two partial
    derivatives ``_partials``; value, jacobian chain rule, ``apply`` and
    ``minmax`` share the generic implementations below."""

    #: the display name of the operator, e.g. ``'+'``
    opstr = None
    #: the scalar/tensor binary operation
    _op = None
    #: its C form: a format of the two operands' expressions
    _c_op = None

    @staticmethod
    @abstractmethod
    def _partials(f1, f2):
        """(d op/d f1, d op/d f2) evaluated at scalar operands."""

    def __init__(self, k1, k2):
        self.k1 = Constant(k1) if np.isscalar(k1) else k1
        self.k2 = Constant(k2) if np.isscalar(k2) else k2

    @property
    def name(self):
        return type(self).__name__

    def __repr__(self):
        return f'{repr(self.k1)} {self.opstr} {repr(self.k2)}'

    def __call__(self, i, j, jac=False):
        if jac is not True:
            return self._op(self.k1(i, j, False), self.k2(i, j, False))
        f1, J1 = self.k1(i, j, True)
        f2, J2 = self.k2(i, j, True)
        g1, g2 = self._partials(f1, f2)
        return self._op(f1, f2), np.concatenate([
            g1 * np.asarray(J1, dtype=float).ravel(),
            g2 * np.asarray(J2, dtype=float).ravel(),
        ])

    def apply(self, theta, X, Y):
        t1, t2 = self._split(theta)
        return self._op(self.k1.apply(t1, X, Y), self.k2.apply(t2, X, Y))

    def c_expr(self, theta, X, Y):
        t1, t2 = self._split(theta)
        a, b = self.k1.c_expr(t1, X, Y), self.k2.c_expr(t2, X, Y)
        return None if a is None or b is None else self._c_op.format(a, b)

    @property
    def n_theta(self):
        return self.k1.n_theta + self.k2.n_theta

    def _split(self, theta):
        n1 = self.k1.n_theta
        return theta[:n1], theta[n1:self.n_theta]

    @property
    def theta(self):
        return pretty_tuple(self.name, ['lhs', 'rhs'])(
            self.k1.theta, self.k2.theta
        )

    @theta.setter
    def theta(self, seq):
        self.k1.theta = seq[0]
        self.k2.theta = seq[1]

    @property
    def bounds(self):
        return (self.k1.bounds, self.k2.bounds)

    @property
    def minmax(self):
        return tuple(starmap(
            self._op, zip(self.k1.minmax, self.k2.minmax)
        ))

    @staticmethod
    def add(k1, k2):
        return Add(k1, k2)

    @staticmethod
    def mul(k1, k2):
        return Multiply(k1, k2)

    @staticmethod
    def pow(k1, c):
        if not (
            np.isscalar(c)
            or (isinstance(c, MicroKernel) and c.name == 'Constant')
        ):
            raise ValueError(
                f'Exponent must be a constant or constant microkernel, '
                f'got {c} instead.'
            )
        return Exponentiation(k1, c)


class Add(MicroKernelExpr):
    opstr = '+'
    _op = staticmethod(operator.add)
    _c_op = '({} + {})'

    @staticmethod
    def _partials(f1, f2):
        return 1.0, 1.0


class Multiply(MicroKernelExpr):
    opstr = '*'
    _op = staticmethod(operator.mul)
    _c_op = '({} * {})'

    @staticmethod
    def _partials(f1, f2):
        return f2, f1


class Exponentiation(MicroKernelExpr):
    opstr = '**'
    _op = staticmethod(operator.pow)
    _c_op = 'powf({}, {})'

    @staticmethod
    def _partials(f1, f2):
        return f2 * f1 ** (f2 - 1), f1 ** f2 * np.log(f1)


def Constant(c, c_bounds='fixed'):
    r"""A no-op microkernel that returns a constant value
    :math:`k_\mathrm{c}(\cdot, \cdot) \equiv c`; often multiplied with
    other microkernels as an adjustable weight."""

    class ConstantKernel(MicroKernel):

        @property
        def name(self):
            return 'Constant'

        def __init__(self, c, c_bounds):
            self.c = float(c)
            self.c_bounds = c_bounds
            self._assert_bounds('c', c_bounds)

        def __call__(self, i, j, jac=False):
            if jac is True:
                return self.c, np.ones(1)
            else:
                return self.c

        def __repr__(self):
            return f'{self.name}({self.c})'

        @property
        def n_theta(self):
            return 1

        def apply(self, theta, X, Y):
            # broadcast the constant against the input feature shape
            shape = torch.broadcast_shapes(
                *[v.shape for v in _leaf_arrays(X, Y)]
            )
            return theta[0].expand(shape)

        def c_expr(self, theta, X, Y):
            return theta[0]

        @property
        def theta(self):
            return pretty_tuple(self.name, ['c'])(self.c)

        @theta.setter
        def theta(self, seq):
            self.c = seq[0]

        @property
        def bounds(self):
            return (self.c_bounds,)

        @property
        def minmax(self):
            return (self.c, self.c)

    return ConstantKernel(c, c_bounds)


def _leaf_arrays(*features):
    """Yield the leaf tensors of feature pytrees (for shape broadcasting)."""
    for f in features:
        if isinstance(f, dict):
            yield from _leaf_arrays(*f.values())
        elif isinstance(f, tuple):
            # (values, mask) variable-length feature: contributes the shape
            # WITHOUT the padded trailing axis
            yield f[0][..., 0]
        else:
            yield f


def Normalize(kernel):
    r"""Normalize the value range of a microkernel to [0, 1] via
    :math:`k_{n}(x, y) = k(x, y) / \sqrt{k(x, x) k(y, y)}`."""
    if kernel.name == 'Normalize':
        return kernel

    class Normalized(MicroKernel):

        @property
        def name(self):
            return 'Normalize'

        def __init__(self, kernel):
            self.kernel = kernel

        def __call__(self, X, Y, jac=False):
            if jac is True:
                Fxx, Jxx = self.kernel(X, X, jac=True)
                Fxy, Jxy = self.kernel(X, Y, jac=True)
                Fyy, Jyy = self.kernel(Y, Y, jac=True)
                if Fxx > 0 and Fyy > 0:
                    return (
                        Fxy * (Fxx * Fyy)**-0.5,
                        (Jxy * (Fxx * Fyy)**-0.5
                         - (0.5 * Fxy * (Fxx * Fyy)**-1.5
                            * (Jxx * Fyy + Fxx * Jyy)))
                    )
                else:
                    return (0.0, np.zeros_like(np.asarray(Jxy)))
            else:
                Fxx = self.kernel(X, X)
                Fxy = self.kernel(X, Y)
                Fyy = self.kernel(Y, Y)
                if Fxx > 0 and Fyy > 0:
                    return Fxy * (Fxx * Fyy)**-0.5
                else:
                    return 0.0

        def __repr__(self):
            return f'{self.name}({repr(self.kernel)})'

        @property
        def n_theta(self):
            return self.kernel.n_theta

        def apply(self, theta, X, Y):
            Fxy = self.kernel.apply(theta, X, Y)
            Fxx = self.kernel.apply(theta, X, X)
            Fyy = self.kernel.apply(theta, Y, Y)
            return _safe_div(Fxy, torch.sqrt(Fxx * Fyy))

        def c_expr(self, theta, X, Y):
            parts = [self.kernel.c_expr(theta, *xy)
                     for xy in ((X, Y), (X, X), (Y, Y))]
            if None in parts:
                return None
            return ('[](float xy, float xx, float yy) { '
                    'const float den = sqrtf(xx * yy); '
                    'return den > 0.F ? xy / den : 0.F; }'
                    f'({", ".join(parts)})')

        @property
        def theta(self):
            return self.kernel.theta

        @theta.setter
        def theta(self, seq):
            self.kernel.theta = seq

        @property
        def bounds(self):
            return self.kernel.bounds

        @property
        def minmax(self):
            lo, hi = self.kernel.minmax
            return (lo / hi, 1)

    return Normalized(kernel)
