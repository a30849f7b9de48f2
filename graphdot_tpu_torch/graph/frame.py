"""Lightweight dict-of-columns frame for graph node/edge attributes.

API parity with the reference minipandas layer
(``graphdot/minipandas/dataframe.py:9``, ``series.py:7``), rebuilt on
modern numpy with a different decomposition: indexing, row iteration and
row-signature packing are small free-standing helpers over a plain
column dict. Object columns (variable-length features) track their
common ``concrete_type`` so they can later be packed into padded
arrays by :mod:`graphdot_tpu_torch.graph.batch`.
"""
from collections import namedtuple

import numpy as np

from .typetool import (
    common_concrete_type, common_min_type, _is_scalar_dtype
)


class Series(np.ndarray):
    """1-D ndarray that tracks the concrete element type of object
    columns (fills the role of ``minipandas/series.py:7``)."""

    def __new__(cls, values):
        if isinstance(values, Series):
            return values
        if isinstance(values, np.ndarray):
            series = values.view(cls)
            series._concrete_type = (
                values.dtype if values.dtype.kind != 'O'
                else common_concrete_type.of_values(values))
            return series
        values = list(values)
        kind = common_min_type.of_values(values)
        storage = np.dtype(kind) if _is_scalar_dtype(kind) \
            else np.dtype(object)
        series = np.empty(len(values), dtype=storage).view(cls)
        series[:] = values
        series._concrete_type = kind
        return series

    def __repr__(self):
        return np.array2string(
            self, separator=',', max_line_width=int(1e20))

    @property
    def concrete_type(self):
        try:
            return self._concrete_type
        except AttributeError:
            return self.dtype if self.dtype.kind != 'O' else None

    def __reduce__(self):
        recon, args, state = super().__reduce__()
        return (recon, args, (state, self.__dict__))

    def __setstate__(self, states):
        state, extras = states
        self.__dict__.update(**extras)
        super().__setstate__(state)


def _row_signature(columns, kinds, pack):
    """Aligned numpy struct dtype of one row; with ``pack``, fields are
    ordered by decreasing item size to minimize padding (the graph
    type-compatibility signature, reference ``dataframe.py:55-63``)."""
    order = sorted(columns, key=lambda c: -kinds[c].itemsize) if pack \
        else list(columns)
    return np.dtype(
        [(str(c), kinds[c].newbyteorder('=')) for c in order], align=True)


class DataFrame:
    """Dict-of-columns data frame (fills the role of
    ``minipandas/dataframe.py:9``)."""

    def __init__(self, data=None):
        self._data = {}
        for key, value in (data or {}).items():
            self[key] = value

    # -- column access ----------------------------------------------------

    def __setitem__(self, key, value):
        self._data[key] = Series(value)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._data[key]
        if hasattr(key, '__iter__'):
            index = np.asarray(key)
            if index.dtype.kind == 'b':  # row mask
                return type(self)(
                    {c: v[index] for c, v in self._data.items()})
            return type(self)({c: self._data[c] for c in key})
        raise TypeError(f'Invalid column index {key}')

    def __getattr__(self, name):
        data = self.__dict__.get('_data', {})
        if name in data:
            return data[name]
        raise AttributeError(f'Dataframe has no column {name}.')

    def __repr__(self):
        return repr(self._data)

    def __len__(self):
        return max(map(len, self._data.values()), default=0)

    def __contains__(self, column):
        return column in self._data

    def __iter__(self):
        return iter(self._data)

    @property
    def columns(self):
        return list(self._data)

    def rowtype(self, pack=True):
        kinds = {}
        for c in self.columns:
            t = self[c].concrete_type
            kinds[c] = np.dtype(t) if _is_scalar_dtype(t) \
                else np.dtype(object)
        return _row_signature(self.columns, kinds, pack)

    # -- row access ---------------------------------------------------------

    def rows(self, rowname='row'):
        """Iterate over rows as namedtuples; non-identifier columns such
        as '!i' are skipped (access them by column instead)."""
        visible = [c for c in self._data if c.isidentifier()]
        fields = [self._data[c] for c in visible]

        class Row(namedtuple(rowname, visible)):
            def __getitem__(self, key):
                return getattr(self, key) if isinstance(key, str) \
                    else super().__getitem__(key)

        Row.__name__ = rowname
        for values in zip(*fields) if fields else ():
            yield Row(*values)
        if not fields:
            for _ in range(len(self)):
                yield Row()

    def itertuples(self, tuplename='tuple'):
        yield from self.rows(rowname=tuplename)

    def iterrows(self, rowname='row'):
        yield from enumerate(self.rows(rowname=rowname))

    # -- conversion & lifecycle ----------------------------------------------

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(
            {c: np.asarray(v) for c, v in self._data.items()})

    def copy(self, deep=False):
        source = self._data
        if deep:
            source = {c: np.copy(v) for c, v in source.items()}
        return type(self)(source)

    def drop(self, keys, inplace=False):
        if inplace:
            for key in keys:
                del self._data[key]
            return None
        return self[[c for c in self.columns if c not in keys]]
