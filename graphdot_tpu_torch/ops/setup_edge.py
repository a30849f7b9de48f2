"""The edge coupling T of the product-graph systems in one pass:
``csrc/setup_edge.cu``, generated from the edge microkernel.

    T[p, a, b] = (w1[p, a] != 0 and w2[p, b] != 0)
                 ? (k_edge(f1[p, a], f2[p, b]; theta) * w1[p, a]) * w2[p, b] : 0

:func:`lower` asks the edge kernel for its float32 C expression
(``MicroKernel.c_expr``, beside each microkernel's ``apply``) over the
feature columns of each side and its hyperparameters, and splices it into
the template. A kernel with no such expression (``Convolution``,
``DotProduct``, an elementary kernel over several columns) declines:
:func:`lower` returns None, and the caller keeps the plain path; so does
a column of variable-length or non-float32 features (:func:`columns_of`).

The generated C text depends on the expression alone: the hyperparameters
are read from the device at each launch (the edge kernel's slice of theta),
so a new theta builds nothing and reads nothing back to the host. The text
is built by ``_build.load_text`` once a checkout and loaded once a process;
:func:`setup_edge` launches it on CUDA tensors and counts the launch.
"""
import ctypes
import functools
import weakref
from collections.abc import Mapping
from pathlib import Path

import torch

from . import _build

_TEMPLATE = Path(__file__).resolve().parent.parent / 'csrc' / 'setup_edge.cu'
_MARKER = '// @EDGE_KERNEL@'


class Lowered:
    """An edge kernel lowered to the C expression ``expr`` over the feature
    columns ``columns`` (those it reads, in the order of the arrays
    ``x[]`` and ``y[]`` of each side) and its ``n_theta`` hyperparameters
    (``th[]``). ``source`` is the text that replaces the template's marker:
    the constants ``kFeatures``, ``kTheta`` and ``kSlots`` and the device
    function ``edge_kernel(x, y, th)``; ``kernel_source`` the whole CUDA
    source."""

    def __init__(self, expr, columns, n_theta):
        self.expr = expr
        self.columns = tuple(columns)
        self.n_theta = n_theta
        self.source = '\n'.join([
            f'constexpr int kFeatures = {len(self.columns)};',
            f'constexpr int kTheta = {n_theta};',
            'constexpr int kSlots = kFeatures > 0 ? kFeatures : 1;',
            '__device__ __forceinline__ float edge_kernel('
            'const float *x, const float *y, const float *th) {',
            f'    return {expr};',
            '}'])
        template = _TEMPLATE.read_text()
        if _MARKER not in template:
            raise RuntimeError(f'{_TEMPLATE} has no line {_MARKER!r}')
        self.kernel_source = template.replace(_MARKER, self.source)


class _Columns(Mapping):
    """One side's feature columns as C expressions, ``x[i]``, numbered by
    the order of first reads across both sides (``read``), so that the
    kernel loads only the columns its expression reads."""

    def __init__(self, side, names, read):
        self.side, self.names, self.read = side, names, read

    def __getitem__(self, name):
        if name not in self.names:
            raise KeyError(name)
        if name not in self.read:
            self.read.append(name)
        return f'{self.side}[{self.read.index(name)}]'

    def __contains__(self, name):
        return name in self.names

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)


#: kernel -> {feature names: Lowered or None}
_LOWERED = weakref.WeakKeyDictionary()


def lower(kernel, names):
    """The edge ``kernel`` lowered over the feature columns ``names`` (the
    keys of the operands' feature dict, in order), or None where it
    declines. Cached by kernel and names: a kernel's expression does not
    change with its hyperparameters."""
    names = tuple(names)
    cache = _LOWERED.setdefault(kernel, {})
    if names not in cache:
        read = []
        expr = kernel.c_expr([f'th[{j}]' for j in range(kernel.n_theta)],
                             _Columns('x', names, read),
                             _Columns('y', names, read))
        cache[names] = (None if expr is None
                        else Lowered(expr, read, kernel.n_theta))
    return cache[names]


def columns_of(lowered, feats):
    """The float32 tensors of the lowered kernel's columns in the feature
    dict ``feats``; None where one is not (a variable-length or an integer
    feature): such a call keeps the plain path."""
    cols = [feats.get(name) for name in lowered.columns]
    if all(isinstance(c, torch.Tensor) and c.dtype == torch.float32
           for c in cols):
        return cols
    return None


@functools.lru_cache(maxsize=None)
def _library(text):
    lib = _build.load_text('setup_edge', text)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.graphdot_setup_edge.argtypes = [ptr] * 6 + [cint] * 4 + [ptr]
    lib.graphdot_setup_edge.restype = cint
    lib.graphdot_cuda_error_string.argtypes = [cint]
    lib.graphdot_cuda_error_string.restype = ctypes.c_char_p
    return lib


def setup_edge(lowered, theta, cols1, cols2, w1, w2):
    """T [P, M1, M2] float32 of the lowered edge kernel at ``theta`` (the
    kernel's hyperparameters, [n_theta]) over the feature columns (lists
    of [P, M1] and [P, M2] float32 tensors, in ``lowered.columns``' order)
    and the edge weights w1 [P, M1], w2 [P, M2].

    Launches ``csrc/setup_edge.cu`` as generated for the kernel on the
    current stream (no wait on the device), and adds one to
    ``setup_edge.launches``. Raises on tensors off a CUDA device and when
    the launch fails."""
    if w1.device.type != 'cuda':
        raise ValueError(f'setup_edge runs on a CUDA device, not {w1.device}')
    P, M1 = w1.shape
    M2 = w2.shape[1]
    operands = [t.contiguous() for t in (w1, w2, *cols1, *cols2)]
    for t, m in zip(operands, [M1, M2] + [M1] * len(cols1)
                    + [M2] * len(cols2)):
        if t.dtype != torch.float32 or t.device != w1.device or \
                tuple(t.shape) != (P, m):
            raise ValueError(
                f'setup_edge takes float32 [P, M] operands on {w1.device}; '
                f'got {t.dtype} {tuple(t.shape)} on {t.device}')
    w1, w2 = operands[:2]
    side2 = [w2] + operands[2 + len(cols1):]
    theta = theta.to(w1.device, torch.float32).contiguous()
    T = torch.empty(P, M1, M2, dtype=torch.float32, device=w1.device)
    vec = M2 % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in side2)
    lib = _library(lowered.kernel_source)
    n = len(lowered.columns)
    cols = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in part))
            for part in (operands[2:2 + n], operands[2 + n:])]
    with torch.cuda.device(w1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.graphdot_setup_edge(
            cols[0], cols[1], w1.data_ptr(), w2.data_ptr(),
            theta.data_ptr(), T.data_ptr(), P, M1, M2, int(vec), stream)
    if err:
        msg = lib.graphdot_cuda_error_string(err).decode()
        raise RuntimeError(f'setup_edge launch failed: CUDA error {err} '
                           f'({msg})')
    setup_edge.launches += 1
    return T


#: kernel launches of ``csrc/setup_edge.cu`` in this process
setup_edge.launches = 0
