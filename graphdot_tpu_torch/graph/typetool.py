"""Type inference over heterogeneous feature columns.

Numpy-2-compatible re-design of the reference type bridge
(``graphdot/codegen/typetool.py:26,114``). The reference used this layer to
map Python feature values onto aligned C structs for CUDA codegen; here it
only has to find the smallest common dtype so that feature columns can be
packed into dense arrays for the product-graph solver.
"""
import numpy as np


def _is_scalar_dtype(t):
    """True if ``t`` is (convertible to) a concrete numpy scalar dtype."""
    try:
        return np.dtype(t).kind not in 'O'
    except TypeError:
        return False


def _fold_types(kinds, coerce, min_float, ensure_signed):
    """Reduce a stream of dtypes/Python types to their smallest common
    type; None when they cannot be merged (mixed object types, or any
    mismatch with coerce=False)."""
    merged = None
    for kind in kinds:
        if ensure_signed and isinstance(kind, np.dtype) \
                and kind.kind == 'u':
            kind = np.promote_types(kind, np.int8)
        if merged is None or merged == kind:
            merged = kind
        elif coerce and isinstance(merged, np.dtype) \
                and isinstance(kind, np.dtype):
            merged = np.promote_types(merged, kind)
        else:
            return None
    if isinstance(merged, np.dtype) and merged.kind == 'f':
        merged = np.promote_types(merged, min_float)
    return merged


class common_min_type:
    """Smallest common dtype over values or types (reference
    ``typetool.py:26``)."""

    @staticmethod
    def of_values(iterable, coerce=True, min_float=np.float32,
                  ensure_signed=True):
        return _fold_types(
            (np.min_scalar_type(v) if np.isscalar(v) else type(v)
             for v in iterable),
            coerce, min_float, ensure_signed)

    @staticmethod
    def of_types(types, coerce=True, min_float=np.float32,
                 ensure_signed=True):
        return _fold_types(iter(types), coerce, min_float, ensure_signed)


class common_concrete_type:
    """Common concrete Python type of all elements, or None (reference
    ``typetool.py:114``)."""

    @staticmethod
    def of_types(types):
        stream = iter(types)
        first = next(stream, None)
        return first if all(t == first for t in stream) else None

    @staticmethod
    def of_values(iterable):
        return common_concrete_type.of_types(map(type, iterable))


def is_object_dtype(t):
    return not _is_scalar_dtype(t)
